"""Model configuration: the port's copy of ``repro.models.config`` with
torch dtypes in place of ``jnp`` ones."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention flavour
    rope_theta: float = 10_000.0
    window: int | None = None            # sliding-window size (local attn)
    layer_pattern: tuple[str, ...] = ("global",)
    #   entries: "global" | "local" | "recurrent" | "ssd"
    attn_logit_cap: float | None = None  # gemma-2 soft-capping
    final_logit_cap: float | None = None
    tie_embeddings: bool = True

    mlp_kind: str = "swiglu"   # "swiglu" (3 mats) | "gelu" (2 mats)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # encoder-decoder / multimodal prefix (not ported: kept so a config
    # that sets them is refused instead of misread)
    encoder_layers: int = 0
    prefix_tokens: int = 0

    dtype: Any = torch.bfloat16
    kv_cache_dtype: Any = None  # None -> dtype

    # training: activation checkpointing of the blocks in
    # transformer.forward -- "none" | "block" | "full" | "dots" ("dots"
    # saves the outputs of the batch-free matrix products and recomputes
    # the rest, JAX's dots_with_no_batch_dims_saveable)
    remat: str = "block"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.kv_cache_dtype is not None:
            # validated here, as in JAX: the cache builders and the page
            # chooser cast K/V into this dtype without asking again
            dt = self.kv_cache_dtype
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"kv_cache_dtype is not a torch dtype: "
                                 f"{dt!r}")
            if not (dt.is_floating_point and dt.itemsize in (1, 2, 4)):
                raise ValueError(
                    "kv_cache_dtype must be a floating dtype of width 1/2/4 "
                    "bytes (float8_e4m3fn / float8_e5m2, bfloat16 / "
                    f"float16, float32); got {dt}")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def mixer_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Parameters of a dense attention stack (embedding included)."""
        d, v = self.d_model, self.vocab
        hd, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        mats = 3 if self.mlp_kind == "swiglu" else 2
        per_layer = (2 * d + d * hd * (hq + 2 * hkv) + hq * hd * d
                     + mats * d * self.d_ff)
        n = v * d * (1 if self.tie_embeddings else 2)
        return n + self.n_layers * per_layer
