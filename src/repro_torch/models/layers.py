"""Model layers: each declares ParamDefs and provides apply functions
(the port of ``repro.models.layers``): norms, RoPE, GQA attention, the
dense MLP, the capacity-based top-k MoE, Mamba-2's SSD mixer and the
RG-LRU recurrent mixer.  Layouts follow the JAX package: weights
``(d_in, d_out)``, attention activations ``(B, S, H, D)``.

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


# ============================ MoE (top-k) ==================================


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), scale=fan_in_scale(d)),
        "w_gate": ParamDef((e, d, f), scale=fan_in_scale(d)),
        "w_up": ParamDef((e, d, f), scale=fan_in_scale(d)),
        "w_down": ParamDef((e, f, d), scale=fan_in_scale(f)),
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
    """Capacity-based top-k MoE, JAX's off-mesh dispatch
    (``_moe_apply_ref``).  x: (B, S, D) -> (out (B, S, D), the Switch
    load-balance aux loss).

    Each of the T = B * S tokens picks its k experts by router
    probability (weights renormalised over the k); the (token, expert)
    pairs are sorted by expert, stably, so each expert takes its tokens
    in token order, and a pair past the expert's :func:`moe_capacity`
    slots is dropped (its weight zeroed).  The experts run as batched
    products over their (E, cap, D) buffers; each token then sums its k
    weighted rows in a fixed order, ascending expert (JAX's scatter-add
    order), so repeats agree bit for bit.  On a paged decode step T is
    every slot of the batch, idle ones included, as in JAX."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)

    logits = (xf @ params["router"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)                               # (T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch-style)
    density = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * e

    cap = moe_capacity(cfg, t)
    e_flat = topi.reshape(-1)                                   # (T * k,)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    w_sort = topw.reshape(-1)[order]
    tok_sort = order // k
    pos = torch.arange(t * k, device=x.device) - torch.searchsorted(
        e_sort, e_sort, side="left")
    keep = pos < cap
    slot = torch.where(keep, e_sort * cap + pos, e * cap)       # drop slot

    rows = xf[tok_sort] * keep[:, None].to(x.dtype)
    buf = x.new_zeros((e * cap + 1, d)).index_put((slot,), rows)
    buf = buf[:-1].reshape(e, cap, d)

    g = F.silu(torch.bmm(buf, params["w_gate"]).float())
    u = torch.bmm(buf, params["w_up"]).float()
    h = (g * u).to(x.dtype)
    out_e = torch.bmm(h, params["w_down"]).to(x.dtype)         # (E, cap, D)

    flat = torch.cat([out_e.reshape(e * cap, d), x.new_zeros((1, d))])
    gathered = flat[slot] * (w_sort * keep)[:, None].to(x.dtype)
    # back to (token, choice), the choices of a token in expert order
    per_tok = gathered[torch.argsort(order)].reshape(t, k, d)
    by_expert = torch.argsort(topi, dim=1)
    per_tok = torch.gather(per_tok, 1, by_expert[..., None].expand(t, k, d))
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out.reshape(b, s, d), aux


# ============================ SSD (mamba-2) ================================


def ssd_defs(cfg: ModelConfig) -> dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_dim = di + 2 * ns
    proj_out = 2 * di + 2 * ns + nh        # z, x, B, C, dt
    return {
        "in_proj": ParamDef((d, proj_out), scale=fan_in_scale(d)),
        "conv_w": ParamDef((cfg.conv_width, conv_dim),
                           scale=fan_in_scale(cfg.conv_width)),
        "A_log": ParamDef((nh,), init="zeros", dtype=torch.float32),
        "D": ParamDef((nh,), init="ones", dtype=torch.float32),
        "dt_bias": ParamDef((nh,), init="zeros", dtype=torch.float32),
        "norm_scale": ParamDef((di,), init="ones"),
        "out_proj": ParamDef((di, d), scale=fan_in_scale(di)),
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


def _gated_norm(params: dict, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before the out-projection, in fp32."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()


def ssd_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
              return_cache: bool = False):
    """Chunked state-space-duality forward (Mamba-2 §6).  x: (B, S, D).

    Within a chunk the output is the masked "attention-like" product;
    across chunks the fp32 states (B, H, P, N) run a loop over the
    chunks.  ``return_cache`` also returns the decode state ``{"conv":
    the last conv_width - 1 conv inputs, "state": the final state}``."""
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
    y = _gated_norm(params, y.reshape(b, s, di), z)
    out = y.to(x.dtype) @ params["out_proj"]
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


def ssd_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, di + 2 * ns),
                         init="zeros", dtype=cfg.dtype),
        "state": ParamDef((batch, nh, hp, ns), init="zeros",
                          dtype=torch.float32),
    }


def ssd_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token SSD step, an O(1) state update.  x: (B, 1, D);
    returns (out (B, 1, D), the new ``{"conv", "state"}``)."""
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
    y = _gated_norm(params, y.reshape(b, di), z)
    out = (y.to(x.dtype) @ params["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "state": state}


# ========================= RG-LRU (recurrentgemma) =========================

_LRU_C = 8.0


def rglru_defs(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "in_x": ParamDef((d, w), scale=fan_in_scale(d)),
        "in_gate": ParamDef((d, w), scale=fan_in_scale(d)),
        "conv_w": ParamDef((cfg.conv_width, w),
                           scale=fan_in_scale(cfg.conv_width)),
        "w_r": ParamDef((w, w), scale=fan_in_scale(w)),
        "w_i": ParamDef((w, w), scale=fan_in_scale(w)),
        "lam": ParamDef((w,), init="ones", dtype=torch.float32),
        "out": ParamDef((w, d), scale=fan_in_scale(w)),
    }


def _rglru_gates(params: dict, xr: torch.Tensor):
    r = torch.sigmoid((xr @ params["w_r"]).float())
    i = torch.sigmoid((xr @ params["w_i"]).float())
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
                return_cache: bool = False):
    """Griffin recurrent block: conv1d -> RG-LRU -> GeLU gate.  x: (B, S,
    D).  ``return_cache`` also returns the decode state ``{"conv": the
    last conv_width - 1 conv inputs, "h": the last hidden state}``."""
    gate = F.gelu((x @ params["in_gate"]).float(), approximate="tanh")
    xr_raw = x @ params["in_x"]
    xr = _causal_conv1d(xr_raw, params["conv_w"])
    a, gated = _rglru_gates(params, xr)
    h = linear_scan(a, gated)
    out = (h * gate).to(x.dtype) @ params["out"]
    if not return_cache:
        return out
    return out, {"conv": _conv_tail(cfg, xr_raw), "h": h[:, -1, :]}


def rglru_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    w = cfg.lru_width
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, w), init="zeros",
                         dtype=cfg.dtype),
        "h": ParamDef((batch, w), init="zeros", dtype=torch.float32),
    }


def rglru_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token RG-LRU step.  x: (B, 1, D); returns (out (B, 1, D),
    the new ``{"conv", "h"}``)."""
    gate = F.gelu((x[:, 0] @ params["in_gate"]).float(), approximate="tanh")
    conv, new_conv = _conv_step(cache["conv"], x[:, 0] @ params["in_x"],
                                params["conv_w"])
    a, gated = _rglru_gates(params, conv.to(x.dtype))
    h = a * cache["h"] + gated
    y = (h * gate).to(x.dtype) @ params["out"]
    return y[:, None, :], {"conv": new_conv, "h": h}
