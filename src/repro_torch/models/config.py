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

    # SSM (mamba-2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0          # 0 -> d_model

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0        # the frontend stub's sequence length

    # multimodal frontend stub (vlm): the number of prefix embeddings the
    # caller supplies pre-computed (``data.pipeline.make_batch``)
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
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
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

    @property
    def is_attention_free(self) -> bool:
        return all(p == "ssd" for p in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True when the decode state does not grow linearly with a full
        attention cache (SSM state, RG-LRU state, local window only)."""
        return all(p in ("ssd", "recurrent", "local")
                   for p in self.layer_pattern)

    def mixer_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    @property
    def d_inner(self) -> int:   # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -- parameter / FLOP accounting (JAX's, per mixer) ----------------------

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        for i in range(self.n_layers):
            n += self._layer_params(self.mixer_for_layer(i))
        for _ in range(self.encoder_layers):
            n += self._layer_params("global") + \
                2 * (2 * d * self.n_heads * self.head_dim)  # cross-attn q,o
        return n

    def _layer_params(self, mixer: str) -> int:
        d = self.d_model
        hd, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        n = 2 * d  # norms
        if mixer in ("global", "local"):
            n += d * hd * (hq + 2 * hkv) + hq * hd * d
        elif mixer == "recurrent":
            w = self.lru_width
            n += 2 * d * w + w * d + 3 * w + self.conv_width * w
        elif mixer == "ssd":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            n += d * (2 * di + 2 * ns + nh) + di * d + \
                self.conv_width * (di + 2 * ns) + 2 * nh
        mats = 3 if self.mlp_kind == "swiglu" else 2
        if self.n_experts:
            n += d * self.n_experts  # router
            n += self.n_experts * 3 * d * self.moe_d_ff
        elif self.d_ff:
            n += mats * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        total -= self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        total += self.n_layers * self.experts_per_token * 3 * d * \
            self.moe_d_ff
        return total

    def model_flops_per_token(self) -> float:
        """6 * N_active (the standard training-FLOPs estimate)."""
        return 6.0 * self.active_param_count()
