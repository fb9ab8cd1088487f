"""Model layers: each declares ParamDefs and provides apply functions
(the port of ``repro.models.layers``): norms, RoPE, GQA attention, the
dense MLP, the capacity-based top-k MoE, Mamba-2's SSD mixer and the
RG-LRU recurrent mixer.  Layouts follow the JAX package: weights
``(d_in, d_out)``, attention activations ``(B, S, H, D)``.

Every ``*_defs`` takes ``model_ax``, the model axis's size, and gives
each leaf JAX's partition spec (``models/sharding.py``): weights are
split over ``model`` (heads, ffn, experts, vocab) where ``model_ax``
divides the dimension, and replicated where it does not; the other
dimension of every weight is split over ``data`` (FSDP storage).  The
caches split the batch over ``data`` and the kv heads over ``model``,
or the sequence where the kv heads do not divide.  ``model_ax`` 1 (the
default) is the unsharded model.

The MoE, SSD and RG-LRU layers have no Pallas kernel in JAX, and none
here: their products are ``@``/``bmm``/``einsum`` on the card's library,
as XLA's dots are in JAX.  Their fp32 leaves (``A_log``, ``D``,
``dt_bias``, ``lam``) stay fp32 in a bf16 model, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.base import ParamDef, fan_in_scale
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding, spmd
from repro_torch.models.sharding import P


def _shard_if(dim: int, model_ax: int, axis: str = "model"):
    return axis if model_ax > 1 and dim % model_ax == 0 else None

# =========================== norms & embeddings ===========================


def rmsnorm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), init="ones", spec=P(None))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * params["scale"].float()).to(x.dtype)


def padded_vocab(cfg: ModelConfig, model_ax: int = 1) -> int:
    """Vocab rounded up to a multiple of ``16 * model_ax`` (JAX's padding,
    which lane-aligns every shard; JAX's default ``model_ax`` is 16, the
    port's 1, the unsharded model)."""
    mult = max(model_ax, 1) * 16
    return ((cfg.vocab + mult - 1) // mult) * mult


def embedding_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    v = padded_vocab(cfg, model_ax)
    return {"embedding": ParamDef((v, cfg.d_model),
                                  scale=cfg.d_model ** -0.5,
                                  spec=P(_shard_if(v, model_ax), "data"))}


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


def attention_specs(cfg: ModelConfig, model_ax: int):
    """(q spec entry, kv spec entry): the query heads split over
    ``model`` where ``model_ax`` divides them, the kv heads where it
    divides theirs (else replicated: every rank keeps every kv head)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    sq = _shard_if(hq * cfg.head_dim, model_ax) if hq % model_ax == 0 \
        or model_ax <= 1 else None
    skv = "model" if model_ax > 1 and hkv % model_ax == 0 else None
    return sq, skv


def attention_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    sq, skv = attention_specs(cfg, model_ax)
    s = fan_in_scale(d)
    return {
        "wq": ParamDef((d, hq * hd), scale=s, spec=P("data", sq)),
        "wk": ParamDef((d, hkv * hd), scale=s, spec=P("data", skv)),
        "wv": ParamDef((d, hkv * hd), scale=s, spec=P("data", skv)),
        "wo": ParamDef((hq * hd, d), scale=fan_in_scale(hq * hd),
                       spec=P(sq, "data")),
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
    return out, _kv_cache(cfg, k, v, cache_len, window, full_cache)


def _kv_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
              cache_len: int, window: int | None,
              full_cache: bool) -> dict:
    """The dense K/V cache of a prompt's (B, S, H, D) keys and values:
    zero-padded to ``cache_len``, or a ring buffer for a windowed layer
    (unless ``full_cache``)."""
    b, s, h, hd = k.shape
    # attention ran over the wide K/V; only the cache is cast (to fp8 for
    # an fp8 pool), as in JAX.  Padding or placing before the cast gives
    # the same bytes and needs no fp8 op but the cast.
    cache_dtype = cfg.kv_cache_dtype or cfg.dtype
    if window is not None and not full_cache:
        # ring buffer: slot p % L holds position p; keep the last L
        length = min(window, cache_len)
        last = torch.arange(s - min(length, s), s, device=k.device)
        ring = {}
        for name, t in (("k", k), ("v", v)):
            c = t.new_zeros((b, length, h, hd))
            c[:, last % length] = t[:, last]
            ring[name] = c.to(cache_dtype)
        return ring
    pad = (0, 0, 0, 0, 0, cache_len - s)
    return {"k": F.pad(k, pad).to(cache_dtype),
            "v": F.pad(v, pad).to(cache_dtype)}


def _cache_layout(cfg: ModelConfig, length: int, model_ax: int) -> str:
    """Where a (B, L, Hkv, D) cache splits over the model axis
    (:func:`attention_cache_defs`): ``"heads"``, ``"seq"`` or
    ``"replicated"``."""
    if model_ax > 1 and cfg.n_kv_heads % model_ax == 0:
        return "heads"
    if model_ax > 1 and length % model_ax == 0:
        return "seq"
    return "replicated"


def _kv_weights(cfg: ModelConfig, params: dict, kv_heads: list[int],
                group, model_ax: int, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kv projections of a rank's kv heads.  Where the kv heads are
    split over the model axis the local weights are they; where they are
    replicated, the rank's columns of them, entered into the
    tensor-parallel region (their gradient summed over the model
    axis)."""
    wk, wv = params["wk"], params["wv"]
    if group is None or attention_specs(cfg, model_ax)[1] is not None:
        return wk, wv
    cols = spmd.kv_columns(kv_heads, cfg.head_dim).to(device)
    return (spmd.copy_to(wk, group)[:, cols],
            spmd.copy_to(wv, group)[:, cols])


def attention_apply_mesh(cfg: ModelConfig, params: dict, x: torch.Tensor,
                         positions: torch.Tensor, *, causal: bool = True,
                         window: int | None = None,
                         return_cache: bool | int = False,
                         full_cache: bool = False, use_kernel: bool = True):
    """:func:`attention_apply` on the active mesh, over the rank's local
    weights (after the FSDP gather) and its batch rows.

    Tensor parallel where the query heads split (``spmd.head_plan``):
    ``x`` enters the region, q/k/v and the attention kernel (row 4, and
    row 5 backward) run on the local heads, and ``wo``'s partial sums are
    all-reduced over the model axis.  A query head uses its own kv head:
    where the kv heads do not split, each rank projects the kv heads its
    query heads need (several ranks may share one).  The returned cache
    is the rank's shard under ``attention_cache_defs``' spec: its kv
    heads, its run of slots, or all of it."""
    ctx = sharding.active()
    b, s, _ = x.shape
    hd = cfg.head_dim
    _, hq, kv = spmd.head_plan(cfg, ctx)
    group = ctx.model_group if spmd.tp_split(cfg, ctx) else None
    xt = spmd.copy_to(x, group)
    wk, wv = _kv_weights(cfg, params, kv, group, ctx.model_ax, x.device)
    q = ops.linear(xt, params["wq"], use_kernel).reshape(b, s, hq, hd)
    k = ops.linear(xt, wk, use_kernel).reshape(b, s, len(kv), hd)
    v = ops.linear(xt, wv, use_kernel).reshape(b, s, len(kv), hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal, window=window,
                        logit_cap=cfg.attn_logit_cap, use_kernel=use_kernel)
    out = ops.linear(out.reshape(b, s, hq * hd), params["wo"], use_kernel)
    out = spmd.reduce_from(out, group)
    if not return_cache:
        return out
    cache_len = return_cache if isinstance(return_cache, int) and \
        return_cache is not True else s
    length = min(window, cache_len) if window is not None and \
        not full_cache else cache_len
    layout = _cache_layout(cfg, length, ctx.model_ax)
    if layout != "heads":                # every kv head, all positions
        hkv = cfg.n_kv_heads
        k = rope(ops.linear(x, params["wk"], use_kernel).reshape(
            b, s, hkv, hd), positions, cfg.rope_theta)
        v = ops.linear(x, params["wv"], use_kernel).reshape(b, s, hkv, hd)
    cache = _kv_cache(cfg, k, v, cache_len, window, full_cache)
    if layout == "seq":
        cache = {n: spmd.own_chunk(c, 1, ctx.model_group).contiguous()
                 for n, c in cache.items()}
    return out, cache


def attention_decode_mesh(cfg: ModelConfig, params: dict, x: torch.Tensor,
                          cache: dict, pos: int, *, max_seq: int,
                          window: int | None = None,
                          use_kernel: bool = True
                          ) -> tuple[torch.Tensor, dict]:
    """:func:`attention_decode` on the active mesh: the rank's batch rows
    over its shard of the dense cache (``max_seq`` the cache's global
    length before the window).  Head-sharded and replicated caches take
    the rank's query heads over their kv heads.  A sequence-sharded
    cache (kv heads that do not split over the model axis) holds a run
    of slots on each rank: every rank scores all query heads (gathered
    over the model axis) over its run, the partial softmaxes merge over
    the model axis (``spmd.merge_partials``), and each rank projects its
    heads' rows through its ``wo`` shard.  The new token's K/V are
    written in place where its slot lies on this rank."""
    ctx = sharding.active()
    b = x.shape[0]
    hq_all, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q0, hq, kv = spmd.head_plan(cfg, ctx)
    group = ctx.model_group if spmd.tp_split(cfg, ctx) else None
    length = min(window, max_seq) if window is not None else max_seq
    layout = _cache_layout(cfg, length, ctx.model_ax)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    xr = x[:, 0]
    q = rope(ops.linear(xr, params["wq"], use_kernel).reshape(
        b, 1, hq, hd), posv, cfg.rope_theta)[:, 0]
    wk, wv = params["wk"], params["wv"]
    nk = wk.shape[1] // hd               # local heads, or every kv head
    k = rope(ops.linear(xr, wk, use_kernel).reshape(b, 1, nk, hd), posv,
             cfg.rope_theta)[:, 0]
    v = ops.linear(xr, wv, use_kernel).reshape(b, nk, hd)
    ck, cv = cache["k"], cache["v"]
    slot = pos % length if window is not None else pos
    if window is None and pos >= length:
        raise ValueError(f"position {pos} is past the cache's {length} "
                         "slots (max_seq)")
    first = 0
    if layout == "seq":
        first = spmd.group_index(ctx.model_group) * ck.shape[1]
    if first <= slot < first + ck.shape[1]:
        ck[:, slot - first] = k.to(ck.dtype)
        cv[:, slot - first] = v.to(cv.dtype)
    slots = torch.arange(first, first + ck.shape[1], device=x.device)
    if window is not None:
        kpos = pos - (pos - slots) % length
        valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
    else:
        valid = slots <= pos
    if layout == "seq":
        if group is not None:
            q = spmd.all_gather(q, 1, group)         # every query head
        keys, vals, heads = ck, cv, hkv
    else:
        # a replicated cache holds every kv head: take the rank's
        idx = None if layout == "heads" or kv == list(range(ck.shape[2])) \
            else torch.tensor(kv, device=x.device)
        keys = ck if idx is None else ck.index_select(2, idx)
        vals = cv if idx is None else cv.index_select(2, idx)
        heads = keys.shape[2]
    nq = q.shape[1]
    qh = q.reshape(b, heads, nq // heads, hd)
    logits = torch.einsum("bhgd,blhd->bhgl", qh.float(),
                          keys.float()) * hd ** -0.5
    if cfg.attn_logit_cap is not None:
        logits = cfg.attn_logit_cap * torch.tanh(logits / cfg.attn_logit_cap)
    logits = torch.where(valid, logits, -1e30)
    if layout == "seq":
        mx = logits.amax(dim=-1)
        p = torch.exp(logits - mx[..., None])
        o = torch.einsum("bhgl,blhd->bhgd", p, vals.float())
        out = spmd.merge_partials(o, mx, p.sum(dim=-1), ctx.model_group)
        out = out.reshape(b, hq_all * hd)
        if group is not None:
            out = out[:, q0 * hd:(q0 + hq) * hd]
    else:
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgl,blhd->bhgd", probs, vals.float())
        out = out.reshape(b, hq * hd)
    out = ops.linear(out[:, None].to(x.dtype), params["wo"], use_kernel)
    return spmd.reduce_from(out, group), cache


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
                         window: int | None, model_ax: int = 1) -> dict:
    """The dense decode cache of one attention layer: ``{"k", "v"}``, (B,
    L, Hkv, D) zeros in the cache dtype, L the window for a local layer
    (a ring buffer) and max_seq otherwise.  Sharded over the kv heads
    where ``model_ax`` divides them, else over the sequence where it
    divides L (each rank a run of slots: the decode merges the partial
    softmaxes over ``model``), else replicated over ``model``."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    length = min(window, max_seq) if window is not None else max_seq
    if model_ax > 1 and hkv % model_ax == 0:
        spec = P("data", None, "model", None)       # head-sharded KV
    elif model_ax > 1 and length % model_ax == 0:
        spec = P("data", "model", None, None)       # sequence-sharded KV
    else:
        spec = P("data", None, None, None)
    d = ParamDef((batch, length, hkv, hd), init="zeros",
                 dtype=cfg.kv_cache_dtype or cfg.dtype, spec=spec)
    return {"k": d, "v": d}


# ========================== dense MLP (SwiGLU) =============================


def mlp_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sh = _shard_if(f, model_ax)
    defs = {"w_up": ParamDef((d, f), scale=fan_in_scale(d),
                             spec=P("data", sh)),
            "w_down": ParamDef((f, d), scale=fan_in_scale(f),
                               spec=P(sh, "data"))}
    if cfg.mlp_kind == "swiglu":
        defs["w_gate"] = ParamDef((d, f), scale=fan_in_scale(d),
                                  spec=P("data", sh))
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


# ============================ MoE (top-k) ==================================


def moe_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    se = _shard_if(e, model_ax)   # expert parallelism over the model axis
    return {
        "router": ParamDef((d, e), scale=fan_in_scale(d),
                           spec=P("data", None)),
        "w_gate": ParamDef((e, d, f), scale=fan_in_scale(d),
                           spec=P(se, "data", None)),
        "w_up": ParamDef((e, d, f), scale=fan_in_scale(d),
                         spec=P(se, "data", None)),
        "w_down": ParamDef((e, f, d), scale=fan_in_scale(f),
                           spec=P(se, None, "data")),
    }


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens: ``ceil(T * k / E *
    capacity_factor)`` rounded up to a multiple of 8, at least 8."""
    cap = math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                    * cfg.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg: ModelConfig, params: dict,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE.  x: (B, S, D) -> (out (B, S, D), the
    Switch load-balance aux loss).

    Off a mesh this is JAX's reference dispatch (:func:`_moe_apply_ref`).
    On a mesh of more than one rank whose mapping has a model axis, each
    model-axis shard routes its own slice of the tokens and exchanges
    expert slices with one all-to-all each way (:func:`_moe_apply_sharded`,
    the port of JAX's ``_moe_apply_shardmap``).  Where the token count or
    the experts do not split over the model axis, or there is no model
    axis, the reference dispatch runs over the global tokens
    (:func:`_moe_apply_mesh_ref`).  That choice is JAX's own rule
    (``moe_apply`` and its ``_ShardMapUnavailable``), not a fallback: the
    two dispatches are different functions (per-shard capacity against
    global capacity), and each runs where JAX runs it."""
    ctx = sharding.active()
    if ctx is None:
        return _moe_apply_ref(cfg, params, x)
    if sharding.on_mesh() and ctx.model_axis is not None:
        b, s, _ = x.shape
        if (b * s) % ctx.model_ax == 0 and cfg.n_experts % ctx.model_ax == 0:
            return _moe_apply_sharded(cfg, params, x, ctx)
    return _moe_apply_mesh_ref(cfg, params, x, ctx)


def _moe_route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """(top-k weights renormalised, top-k experts, the aux loss) of (T,
    D) tokens."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax((xf @ router).float(), dim=-1)       # (T, E)
    topw, topi = _top_k(probs, k)                               # (T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    # load-balance aux loss (Switch-style)
    density = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * e
    return topw, topi, aux


def _moe_dispatch(cfg: ModelConfig, xf: torch.Tensor, topw: torch.Tensor,
                  topi: torch.Tensor, cap: int):
    """The (E, cap, D) expert buffers of (T, D) tokens and the plan to
    combine their outputs: pairs sorted by expert, stably, a pair past
    its expert's ``cap`` slots dropped."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    e_flat = topi.reshape(-1)                                   # (T * k,)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    w_sort = topw.reshape(-1)[order]
    tok_sort = order // k
    pos = torch.arange(t * k, device=xf.device) - torch.searchsorted(
        e_sort, e_sort, side="left")
    keep = pos < cap
    slot = torch.where(keep, e_sort * cap + pos, e * cap)       # drop slot
    rows = xf[tok_sort] * keep[:, None].to(xf.dtype)
    buf = xf.new_zeros((e * cap + 1, d)).index_put((slot,), rows)
    return buf[:-1].reshape(e, cap, d), (order, slot, keep, w_sort)


def _moe_experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their (E, cap, D) buffers."""
    g = F.silu(torch.bmm(buf, params["w_gate"]).float())
    u = torch.bmm(buf, params["w_up"]).float()
    h = (g * u).to(buf.dtype)
    return torch.bmm(h, params["w_down"]).to(buf.dtype)


def _moe_combine(cfg: ModelConfig, out_e: torch.Tensor, plan,
                 topi: torch.Tensor) -> torch.Tensor:
    """Each token's k weighted expert rows summed in ascending expert
    order (JAX's scatter-add order), so repeats agree bit for bit."""
    order, slot, keep, w_sort = plan
    e, cap, d = out_e.shape
    t, k = topi.shape
    flat = torch.cat([out_e.reshape(e * cap, d), out_e.new_zeros((1, d))])
    gathered = flat[slot] * (w_sort * keep)[:, None].to(out_e.dtype)
    # back to (token, choice), the choices of a token in expert order
    per_tok = gathered[torch.argsort(order)].reshape(t, k, d)
    by_expert = torch.argsort(topi, dim=1)
    per_tok = torch.gather(per_tok, 1, by_expert[..., None].expand(t, k, d))
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out


def _moe_apply_ref(cfg: ModelConfig, params: dict,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's reference dispatch (``_moe_apply_ref``).

    Each of the T = B * S tokens picks its k experts by router
    probability (weights renormalised over the k); the (token, expert)
    pairs are sorted by expert, stably, so each expert takes its tokens
    in token order, and a pair past the expert's :func:`moe_capacity`
    slots is dropped (its weight zeroed).  The experts run as batched
    products over their (E, cap, D) buffers; each token then sums its k
    weighted rows in a fixed order, ascending expert.  On a paged decode
    step T is every slot of the batch, idle ones included, as in JAX."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    topw, topi, aux = _moe_route(cfg, params["router"], xf)
    buf, plan = _moe_dispatch(cfg, xf, topw, topi, moe_capacity(cfg, b * s))
    out = _moe_combine(cfg, _moe_experts(params, buf), plan, topi)
    return out.reshape(b, s, d), aux


def _moe_apply_sharded(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_moe_apply_shardmap`` over the rank's batch rows and its
    experts (E / M of them, M the model axis's size).

    Model-axis rank r routes its slice r of the (T, D) local tokens (the
    router entered into the model-split region), sizes the expert
    buffers for that slice (:func:`moe_capacity` of T / M tokens), sends
    each peer its experts' buffers (all-to-all: (E / M, M * cap, D) here,
    the peers' buffers side by side in rank order), runs its experts,
    sends the rows back (the inverse all-to-all), combines its tokens in
    ascending expert order and all-gathers the slices over the model
    axis.  ``aux`` is averaged over the model and batch axes."""
    group = ctx.model_group
    m = ctx.model_ax
    b, s, d = x.shape
    tl = b * s
    tm = tl // m
    r = spmd.group_index(group)
    mine = spmd.copy_to(x.reshape(tl, d), group)[r * tm:(r + 1) * tm]
    router = spmd.copy_to(params["router"], group)
    topw, topi, aux = _moe_route(cfg, router, mine)
    axes = tuple(a for a in ctx.mesh.mesh_dim_names
                 if a == ctx.model_axis or a in ctx.batch_axes)
    n = math.prod(ctx.sizes[a] for a in axes)
    aux = spmd.reduce_from(aux / n, ctx.group(axes))            # pmean

    e = cfg.n_experts
    buf, plan = _moe_dispatch(cfg, mine, topw, topi, moe_capacity(cfg, tm))
    cap = buf.shape[1]
    # expert-parallel exchange: send each model peer its experts' slots
    got = spmd.exchange(buf, group)                    # (E, cap, D), M x
    got = got.reshape(m, e // m, cap, d).transpose(0, 1).reshape(
        e // m, m * cap, d)
    out_e = _moe_experts(params, got)                  # (E/M, M*cap, D)
    back = out_e.reshape(e // m, m, cap, d).transpose(0, 1).contiguous()
    out_e = spmd.exchange(back, group).reshape(e, cap, d)
    mine_out = _moe_combine(cfg, out_e, plan, topi)
    out = spmd.gather_replicated(mine_out, 0, group)            # (T, D)
    return out.reshape(b, s, d), aux


def _moe_apply_mesh_ref(cfg: ModelConfig, params: dict, x: torch.Tensor,
                        ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's reference dispatch on a mesh, where XLA runs it over the
    global tokens: the batch rows are gathered over the batch axes, the
    experts over the model axis, every rank dispatches them all, and
    keeps its rows.  The aux loss, the same on every rank, passes
    ``1 / (batch ranks)`` of its gradient back on each, so the batch
    axes' sum counts it once."""
    b, s, d = x.shape
    if _shard_if(cfg.n_experts, ctx.model_ax):       # experts split
        group = ctx.model_group
        params = {**params, **{n: spmd.gather_replicated(params[n], 0, group)
                               for n in ("w_gate", "w_up", "w_down")}}
    xg = spmd.gather_shards(x, 0, ctx.batch_group)
    out, aux = _moe_apply_ref(cfg, params, xg)
    if ctx.batch_group is not None:
        out = spmd.own_chunk(out, 0, ctx.batch_group)
    return out, spmd.scale_grad(aux, 1.0 / ctx.batch_size)


# ============================ SSD (mamba-2) ================================


def ssd_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_dim = di + 2 * ns
    proj_out = 2 * di + 2 * ns + nh        # z, x, B, C, dt
    sdi = _shard_if(di, model_ax)
    return {
        "in_proj": ParamDef((d, proj_out), scale=fan_in_scale(d),
                            spec=P("data", None)),
        "conv_w": ParamDef((cfg.conv_width, conv_dim),
                           scale=fan_in_scale(cfg.conv_width),
                           spec=P(None, None)),
        "A_log": ParamDef((nh,), init="zeros", dtype=torch.float32,
                          spec=P(None)),
        "D": ParamDef((nh,), init="ones", dtype=torch.float32,
                      spec=P(None)),
        "dt_bias": ParamDef((nh,), init="zeros", dtype=torch.float32,
                            spec=P(None)),
        "norm_scale": ParamDef((di,), init="ones", spec=P(sdi)),
        "out_proj": ParamDef((di, d), scale=fan_in_scale(di),
                             spec=P(sdi, "data")),
    }


def _ssd_split(cfg: ModelConfig, proj: torch.Tensor):
    di, ns = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * ns],
            proj[..., 2 * di + 2 * ns:])


def ssd_chunk(cfg: ModelConfig, s: int) -> int:
    """The chunk length for a length-S sequence: ``ssm_chunk``, or S when
    shorter, snapped down to the largest divisor of S (ragged
    prompts)."""
    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = max(v for v in range(1, q + 1) if s % v == 0)
    return q


def _gated_norm(params: dict, y: torch.Tensor, z: torch.Tensor,
                group=None) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before the out-projection, in fp32.  The
    mean runs over the whole d_inner row; with ``group`` (d_inner split
    over the model axis) the rank's columns of the normalised row then
    enter the row-parallel region (``spmd.split_to``), scaled by its
    ``norm_scale`` shard."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6)
    y = spmd.split_to(y, y.dim() - 1, group)
    return y * params["norm_scale"].float()


def ssd_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
              return_cache: bool = False, group=None):
    """Chunked state-space-duality forward (Mamba-2 §6).  x: (B, S, D).

    Within a chunk the output is the masked "attention-like" product;
    across chunks the fp32 states (B, H, P, N) run a loop over the
    chunks.  ``return_cache`` also returns the decode state ``{"conv":
    the last conv_width - 1 conv inputs, "state": the final state}``.

    On a mesh ``group`` is the model axis's group where it splits
    d_inner (``ssd_defs``: only ``norm_scale`` and ``out_proj`` split):
    every rank runs the whole scan on the replicated leaves, and the
    region opens after the gated norm's mean (:func:`_gated_norm`) and
    closes after the row-parallel ``out_proj``; the state stays
    replicated."""
    b, s, _ = x.shape
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = ssd_chunk(cfg, s)
    nc = s // q

    proj = x @ params["in_proj"]
    z, xbc_raw, dt = _ssd_split(cfg, proj)
    xbc = _causal_conv1d(xbc_raw, params["conv_w"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, nh, hp)
    bmat = xbc[..., di:di + ns]                         # (B, S, N), G=1
    cmat = xbc[..., di + ns:]

    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                     # (H,)
    da = dt * a                                         # (B, S, H)

    xc = xs.reshape(b, nc, q, nh, hp)
    bc = bmat.reshape(b, nc, q, ns).float()
    cc = cmat.reshape(b, nc, q, ns).float()
    dac = da.reshape(b, nc, q, nh)
    dtc = dt.reshape(b, nc, q, nh)
    cum = torch.cumsum(dac, dim=2)                      # (B, Nc, Q, H)

    # intra-chunk: the masked decay of position k's input at position q
    # (masked before the exp, so the upper triangle never overflows)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,Nc,Q,Q,H)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    xdt = xc.float() * dtc[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * decay,
                           xdt)

    # chunk-final states, then the recurrence across chunks
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,Nc,Q,H)
    states = torch.einsum("bckn,bckhp->bchpn", bc,
                          xdt * decay_to_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B, Nc, H)
    state = x.new_zeros((b, nh, hp, ns), dtype=torch.float32)
    prev = []
    for c in range(nc):
        prev.append(state)                                 # the PREV state
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,Nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, hp)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = _gated_norm(params, y.reshape(b, s, di), z, group)
    out = spmd.reduce_from(y.to(x.dtype) @ params["out_proj"], group)
    if not return_cache:
        return out
    return out, {"conv": _conv_tail(cfg, xbc_raw), "state": state}


def _conv_tail(cfg: ModelConfig, raw: torch.Tensor) -> torch.Tensor:
    """The last conv_width - 1 conv inputs (B, W - 1, C) in the model
    dtype, zero-padded on the left for a shorter sequence."""
    w_hist = cfg.conv_width - 1
    tail = raw[:, -w_hist:, :].to(cfg.dtype)
    return F.pad(tail, (0, 0, w_hist - tail.shape[1], 0))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, fp32 sums.  x: (B, S, C); w:
    (W, C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :].float() * w[i].float()
    return out.to(x.dtype)


def _conv_step(cache_conv: torch.Tensor, new: torch.Tensor,
               w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of :func:`_causal_conv1d` over the cached inputs:
    returns (the fp32 conv output (B, C), the new history)."""
    hist = torch.cat([cache_conv, new[:, None, :].to(cache_conv.dtype)],
                     dim=1)                                # (B, W, C)
    conv = torch.sum(hist.float() * w.float()[None], dim=1)
    return conv, hist[:, 1:, :]


def ssd_cache_defs(cfg: ModelConfig, batch: int, model_ax: int = 1) -> dict:
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, di + 2 * ns),
                         init="zeros", dtype=cfg.dtype,
                         spec=P("data", None, None)),
        "state": ParamDef((batch, nh, hp, ns), init="zeros",
                          dtype=torch.float32,
                          spec=P("data", None, None, None)),
    }


def ssd_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: dict, group=None) -> tuple[torch.Tensor, dict]:
    """Single-token SSD step, an O(1) state update.  x: (B, 1, D);
    returns (out (B, 1, D), the new ``{"conv", "state"}``).  ``group``
    as in :func:`ssd_apply`."""
    b = x.shape[0]
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dt = _ssd_split(cfg, x[:, 0] @ params["in_proj"])
    conv, new_conv = _conv_step(cache["conv"], xbc, params["conv_w"])
    xbc = F.silu(conv).to(x.dtype)

    xs = xbc[:, :di].reshape(b, nh, hp)
    bvec = xbc[:, di:di + ns].float()
    cvec = xbc[:, di + ns:].float()
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a)                                # (B, H)
    upd = torch.einsum("bn,bh,bhp->bhpn", bvec, dt, xs.float())
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cvec, state)
    y = y + params["D"][None, :, None] * xs.float()
    y = _gated_norm(params, y.reshape(b, di), z, group)
    out = spmd.reduce_from(y.to(x.dtype) @ params["out_proj"],
                           group)[:, None, :]
    return out, {"conv": new_conv, "state": state}


# ========================= RG-LRU (recurrentgemma) =========================

_LRU_C = 8.0


def rglru_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    sw = _shard_if(w, model_ax)
    return {
        "in_x": ParamDef((d, w), scale=fan_in_scale(d), spec=P("data", sw)),
        "in_gate": ParamDef((d, w), scale=fan_in_scale(d),
                            spec=P("data", sw)),
        "conv_w": ParamDef((cfg.conv_width, w),
                           scale=fan_in_scale(cfg.conv_width),
                           spec=P(None, sw)),
        "w_r": ParamDef((w, w), scale=fan_in_scale(w), spec=P("data", sw)),
        "w_i": ParamDef((w, w), scale=fan_in_scale(w), spec=P("data", sw)),
        "lam": ParamDef((w,), init="ones", dtype=torch.float32, spec=P(sw)),
        "out": ParamDef((w, d), scale=fan_in_scale(w), spec=P(sw, "data")),
    }


def _rglru_gates(params: dict, xr: torch.Tensor, group=None):
    """The decay ``a`` and the gated input of the conv output ``xr``.
    With ``group`` (the width split over the model axis) ``xr`` is the
    rank's columns: ``w_r`` and ``w_i`` take the whole row (their rows
    unsplit), gathered over the model axis, whose backward
    reduce-scatters the ranks' partial gradients; ``i * xr`` takes the
    rank's own."""
    xf = spmd.gather_shards(xr, xr.dim() - 1, group)
    r = torch.sigmoid((xf @ params["w_r"]).float())
    i = torch.sigmoid((xf @ params["w_i"]).float())
    a = torch.exp(-_LRU_C * F.softplus(params["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * \
        (i * xr.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a
    log-step doubling scan (Hillis-Steele): ceil(log2 S) passes of
    tensor ops, each combining every position with the one ``d`` before
    it, ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``.  The same
    operator as JAX's ``lax.associative_scan``, associated in another
    order, so fp32 results differ by rounding only."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                return_cache: bool = False, group=None):
    """Griffin recurrent block: conv1d -> RG-LRU -> GeLU gate.  x: (B, S,
    D).  ``return_cache`` also returns the decode state ``{"conv": the
    last conv_width - 1 conv inputs, "h": the last hidden state}``.

    On a mesh ``group`` is the model axis's group where it splits the
    width (``rglru_defs``: every width-w leaf splits): ``in_x`` and
    ``in_gate`` are column-parallel, the conv and the scan elementwise
    on the rank's columns (the gates' products gather the row,
    :func:`_rglru_gates`), ``out`` row-parallel; the state is the rank's
    columns (``rglru_cache_defs``)."""
    x = spmd.copy_to(x, group)
    gate = F.gelu((x @ params["in_gate"]).float(), approximate="tanh")
    xr_raw = x @ params["in_x"]
    xr = _causal_conv1d(xr_raw, params["conv_w"])
    a, gated = _rglru_gates(params, xr, group)
    h = linear_scan(a, gated)
    out = spmd.reduce_from((h * gate).to(x.dtype) @ params["out"], group)
    if not return_cache:
        return out
    return out, {"conv": _conv_tail(cfg, xr_raw), "h": h[:, -1, :]}


def rglru_cache_defs(cfg: ModelConfig, batch: int,
                     model_ax: int = 1) -> dict:
    w = cfg.lru_width
    sw = _shard_if(w, model_ax)
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, w), init="zeros",
                         dtype=cfg.dtype, spec=P("data", None, sw)),
        "h": ParamDef((batch, w), init="zeros", dtype=torch.float32,
                      spec=P("data", sw)),
    }


def rglru_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 cache: dict, group=None) -> tuple[torch.Tensor, dict]:
    """Single-token RG-LRU step.  x: (B, 1, D); returns (out (B, 1, D),
    the new ``{"conv", "h"}``).  ``group`` as in :func:`rglru_apply`."""
    gate = F.gelu((x[:, 0] @ params["in_gate"]).float(), approximate="tanh")
    conv, new_conv = _conv_step(cache["conv"], x[:, 0] @ params["in_x"],
                                params["conv_w"])
    a, gated = _rglru_gates(params, conv.to(x.dtype), group)
    h = a * cache["h"] + gated
    y = spmd.reduce_from((h * gate).to(x.dtype) @ params["out"], group)
    return y[:, None, :], {"conv": new_conv, "h": h}
