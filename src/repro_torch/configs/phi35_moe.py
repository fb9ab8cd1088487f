"""phi3.5-moe-42b-a6.6b: MoE 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab=32064,
    n_experts=16, experts_per_token=2, moe_d_ff=6400,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="phi35-moe-smoke", family="moe",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=0, vocab=256,
                       n_experts=4, experts_per_token=2, moe_d_ff=32)
