"""gemma2-9b: local+global alternating attention, logit soft-capping
[arXiv:2408.00118].  head_dim=256 (decoupled from d_model/n_heads)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    head_dim=256, d_ff=14336, vocab=256000,
    layer_pattern=("local", "global"), window=4096,
    attn_logit_cap=50.0, final_logit_cap=30.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="gemma2-9b-smoke", family="dense",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab=256,
                       layer_pattern=("local", "global"), window=8,
                       attn_logit_cap=50.0, final_logit_cap=30.0)
