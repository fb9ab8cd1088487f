"""recurrentgemma-9b: RG-LRU + local attention, 1:2 ratio
[arXiv:2402.19427].  38 layers = (recurrent, recurrent, local) x 12 + 2."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    head_dim=256, d_ff=12288, vocab=256000,
    layer_pattern=("recurrent", "recurrent", "local"), window=2048,
    lru_width=4096,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="recurrentgemma-smoke", family="hybrid",
                       n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                       head_dim=16, d_ff=128, vocab=256,
                       layer_pattern=("recurrent", "recurrent", "local"),
                       window=8, lru_width=64)
