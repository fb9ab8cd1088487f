"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].  The vision tower is a STUB:
input_specs() provides precomputed patch embeddings (prefix_tokens)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    prefix_tokens=576,   # 24x24 CLIP patch grid
)


def reduced() -> ModelConfig:
    return ModelConfig(name="phi3-vision-smoke", family="vlm",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab=256, prefix_tokens=16)
