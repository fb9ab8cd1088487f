"""seamless-m4t-medium: encoder-decoder multimodal backbone
[arXiv:2308.11596].  The speech/text frontend is a STUB: input_specs()
provides precomputed frame embeddings for the encoder."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, mlp_kind="gelu",
    encoder_layers=12, encoder_seq=1024,
)


def reduced() -> ModelConfig:
    return ModelConfig(name="seamless-smoke", family="encdec",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab=256,
                       encoder_layers=2, encoder_seq=16)
