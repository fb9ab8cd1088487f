"""qwen3-moe-235b-a22b: MoE 128 experts top-8, GQA kv=4
[hf:Qwen/Qwen3-30B-A3B scaled]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    head_dim=128, d_ff=0, vocab=151936,
    n_experts=128, experts_per_token=8, moe_d_ff=1536,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="qwen3-moe-smoke", family="moe",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=0, vocab=256,
                       n_experts=8, experts_per_token=2, moe_d_ff=32)
