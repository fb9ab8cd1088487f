"""mamba2-780m: attention-free SSD (state-space duality)
[arXiv:2405.21060]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    layer_pattern=("ssd",), ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, ssm_chunk=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="mamba2-smoke", family="ssm",
                       n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
                       d_ff=0, vocab=256,
                       layer_pattern=("ssd",), ssm_state=16,
                       ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
