"""Model layers of the dense decoder: each declares ParamDefs and
provides apply functions (the port of ``repro.models.layers`` for the
attention + SwiGLU stack).  Layouts follow the JAX package: weights
``(d_in, d_out)``, attention activations ``(B, S, H, D)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.base import ParamDef, fan_in_scale
from repro_torch.models.config import ModelConfig

# =========================== norms & embeddings ===========================


def rmsnorm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * params["scale"].float()).to(x.dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 16 (the JAX package's padding on
    a one-way model axis)."""
    return ((cfg.vocab + 15) // 16) * 16


def embedding_defs(cfg: ModelConfig) -> dict:
    return {"embedding": ParamDef((padded_vocab(cfg), cfg.d_model),
                                  scale=cfg.d_model ** -0.5)}


# ================================ RoPE =====================================


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ============================ attention (GQA) ==============================


def attention_defs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    s = fan_in_scale(d)
    return {
        "wq": ParamDef((d, hq * hd), scale=s),
        "wk": ParamDef((d, hkv * hd), scale=s),
        "wv": ParamDef((d, hkv * hd), scale=s),
        "wo": ParamDef((hq * hd, d), scale=fan_in_scale(hq * hd)),
    }


def attention_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int | None = None,
                    return_cache: bool | int = False,
                    full_cache: bool = False, use_kernel: bool = True):
    """Full-sequence attention.  x: (B, S, D).

    ``return_cache`` (True, or an int cache length) also returns the K/V
    cache ``{"k", "v"}`` of shape (B, length, Hkv, D), zero-padded past
    S.  A windowed layer's cache is a ring buffer of ``min(window,
    length)`` slots, slot ``p % L`` holding position p, the last L
    positions kept (the dense decode engine's layout,
    :func:`attention_decode`); ``full_cache=True`` keeps it in the full
    position-indexed layout instead — the paged serving path stores
    every layer in pages and masks the window at decode time.
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv_span_proj(cfg, params, x, positions, use_kernel=use_kernel)
    out = ops.attention(q, k, v, causal=causal, window=window,
                        logit_cap=cfg.attn_logit_cap, use_kernel=use_kernel)
    out = ops.linear(out.reshape(b, s, hq * hd), params["wo"], use_kernel)
    if not return_cache:
        return out
    cache_len = return_cache if isinstance(return_cache, int) and \
        return_cache is not True else s
    # attention above ran over the wide K/V; only the cache is cast (to
    # fp8 for an fp8 pool), as in JAX.  Padding or placing before the
    # cast gives the same bytes and needs no fp8 op but the cast.
    cache_dtype = cfg.kv_cache_dtype or cfg.dtype
    if window is not None and not full_cache:
        # ring buffer: slot p % L holds position p; keep the last L
        length = min(window, cache_len)
        last = torch.arange(s - min(length, s), s, device=x.device)
        ring = {}
        for name, t in (("k", k), ("v", v)):
            c = t.new_zeros((b, length, hkv, hd))
            c[:, last % length] = t[:, last]
            ring[name] = c.to(cache_dtype)
        return out, ring
    pad = (0, 0, 0, 0, 0, cache_len - s)
    return out, {"k": F.pad(k, pad).to(cache_dtype),
                 "v": F.pad(v, pad).to(cache_dtype)}


def qkv_span_proj(cfg: ModelConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, use_kernel: bool = True):
    """Q/K/V projection + rope for a span of S consecutive tokens — one
    definition shared by prefill, paged decode (S=1) and chunked prefill.
    x: (B, S, D); positions: (B, S).  Returns q (B, S, Hq, D), k/v
    (B, S, Hkv, D).  With fused ops on (``ops.fused_ops``) the three
    projections are one ``qkv_fused`` pass (``use_kernel=False``: its
    plain version)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if ops.fused_ops_enabled():
        # one weight-stationary pass: x streams from HBM once for all
        # three projections
        q, k, v = ops.qkv_fused(x, params["wq"], params["wk"], params["wv"],
                                use_kernel=use_kernel)
    else:
        q = ops.linear(x, params["wq"], use_kernel)
        k = ops.linear(x, params["wk"], use_kernel)
        v = ops.linear(x, params["wv"], use_kernel)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def qkv_decode_proj(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, use_kernel: bool = True):
    """One-token wrapper over :func:`qkv_span_proj`.  x: (B, D);
    positions: (B, 1).  Returns q (B, Hq, D), k/v (B, Hkv, D)."""
    q, k, v = qkv_span_proj(cfg, params, x[:, None, :], positions,
                            use_kernel=use_kernel)
    return q[:, 0], k[:, 0], v[:, 0]


def attention_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     cache: dict, pos: int, *, window: int | None = None,
                     use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """One-token step over the dense cache, as JAX writes it.  x: (B, 1,
    D); ``pos``: the token's position, one for the whole batch; cache
    ``{"k", "v"}``: (B, L, Hkv, D), L the window (a ring buffer, slot
    ``pos % L``) for local layers, else max_seq.

    The token's K/V are written into the cache in place (cast to its
    dtype); the scores, the cap, the masked softmax and the weighted sum
    are fp32 ``einsum`` s over the whole cache, widened from its dtype (an
    fp8 cache too), outside any kernel, as in JAX; ``wo`` goes through
    :func:`ops.linear`.  Returns (out (B, 1, D), the cache)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv_decode_proj(cfg, params, x[:, 0], posv,
                              use_kernel=use_kernel)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    if window is None and pos >= length:
        raise ValueError(f"position {pos} is past the cache's {length} "
                         "slots (max_seq)")
    slot = pos % length if window is not None else pos
    ck[:, slot] = k.to(ck.dtype)
    cv[:, slot] = v.to(cv.dtype)

    slots = torch.arange(length, device=x.device)
    if window is not None:
        kpos = pos - (pos - slots) % length           # ring-buffer positions
        valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
    else:
        valid = slots <= pos

    qh = q.reshape(b, hkv, hq // hkv, hd)             # (B, hkv, G, D)
    logits = torch.einsum("bhgd,blhd->bhgl", qh.float(),
                          ck.float()) * hd ** -0.5
    if cfg.attn_logit_cap is not None:
        logits = cfg.attn_logit_cap * torch.tanh(logits / cfg.attn_logit_cap)
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", probs, cv.float())
    out = out.reshape(b, 1, hq * hd).to(x.dtype)
    return ops.linear(out, params["wo"], use_kernel), cache


def attention_cache_defs(cfg: ModelConfig, batch: int, max_seq: int,
                         window: int | None) -> dict:
    """The dense decode cache of one attention layer: ``{"k", "v"}``, (B,
    L, Hkv, D) zeros in the cache dtype, L the window for a local layer
    (a ring buffer) and max_seq otherwise."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    length = min(window, max_seq) if window is not None else max_seq
    d = ParamDef((batch, length, hkv, hd), init="zeros",
                 dtype=cfg.kv_cache_dtype or cfg.dtype)
    return {"k": d, "v": d}


# ========================== dense MLP (SwiGLU) =============================


def mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"w_up": ParamDef((d, f), scale=fan_in_scale(d)),
            "w_down": ParamDef((f, d), scale=fan_in_scale(f))}
    if cfg.mlp_kind == "swiglu":
        defs["w_gate"] = ParamDef((d, f), scale=fan_in_scale(d))
    return defs


def mlp_apply(params: dict, x: torch.Tensor,
              residual: torch.Tensor | None = None,
              use_kernel: bool = True) -> torch.Tensor:
    """The MLP block; ``residual`` (when given) is added to the output.

    With fused ops on (``ops.fused_ops``, the serving engine's ``fuse``)
    the chain is three epilogue-fused GEMMs, as in JAX: the gate's silu,
    the gating multiply and the residual add happen on the output tile.
    The rounding points then follow the fused JAX path: the gate is cast
    to the model dtype before it becomes ``mul``, and the residual is
    added in fp32 before the one cast.  ``use_kernel=False``: the fused
    GEMMs' plain version, and the plain int8 GEMM for quantized
    weights."""
    if ops.fused_ops_enabled():
        if "w_gate" in params:  # SwiGLU
            g = ops.matmul_fused(x, params["w_gate"], act="silu",
                                 use_kernel=use_kernel)
            u = ops.matmul_fused(x, params["w_up"], mul=g,
                                 use_kernel=use_kernel)
        else:  # plain GELU MLP
            u = ops.matmul_fused(x, params["w_up"], act="gelu",
                                 use_kernel=use_kernel)
        return ops.matmul_fused(u, params["w_down"], residual=residual,
                                use_kernel=use_kernel)
    u = ops.linear(x, params["w_up"], use_kernel).float()
    if "w_gate" in params:  # SwiGLU
        u = F.silu(ops.linear(x, params["w_gate"], use_kernel).float()) * u
    else:  # plain GELU MLP (jax.nn.gelu's tanh form)
        u = F.gelu(u, approximate="tanh")
    out = ops.linear(u.to(x.dtype), params["w_down"], use_kernel)
    return out if residual is None else residual + out
