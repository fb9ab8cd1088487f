"""Public ops over the port's kernels (the counterpart of
``repro.kernels.ops`` for the serving path).

Each op runs its CUDA kernel through the kernel's wrapper, which
launches on CUDA tensors (or raises) and takes the plain version for CPU
tensors.  ``use_kernel=False`` is the caller's explicit choice of the
plain version on any device: the yardstick a kernel is held against on
the card, never a fallback.

``matmul`` asks the schedule tuner (``repro_torch.tune.best_schedule``)
for its tiles: a tuned, persisted schedule when one is cached for this
(op, shapes, dtype, device), else the blocking model's winner on the
Hopper target.  ``linear`` is a plain ``x @ w`` unless blocked linears
are enabled (``blocked_linear(True)`` or ``REPRO_BLOCKED_LINEAR=1``), in
which case every projection runs ``matmul``.

The fused path (``fused_ops(True)`` or ``REPRO_FUSED_OPS=1``; the
serving engine's ``fuse``) routes the model's hot spots through the
cross-op fused kernels: ``matmul_fused`` (the MLP's epilogue-fused
GEMMs), ``qkv_fused`` (the attention front end in one pass over x) and
``paged_attention_oproj`` (single-token decode with the output
projection fused in), each with its tiles from its own schedule key.
Their kernels mask ragged edges, so no shape falls back to a plain
version (the JAX ops' fallback for tiles that do not divide is not
carried over).

Training: ``matmul`` and ``attention`` are differentiable, as JAX's
``custom_vjp`` ops are.  ``matmul`` is a ``torch.autograd.Function``
whose backward runs the dgrad kernels (``matmul_dgrad_a``/``_b``, kernel
rows 7 and 8) under the ``"matmul_dgrad"`` key; ``attention``'s kernel
carries its own backward (``flash_attention_bwd``, row 5).  The fused
and quantized ops stay inference-only, as in JAX.

The quantized path: a weight may be a
:class:`repro_torch.quant.QuantizedTensor`.  ``linear`` sends a 2-D
int8 one to ``matmul_w8`` (int8 weights streamed at one byte, the scale
in the epilogue; tiles from the ``"matmul_w8"`` key) -- on every device,
where JAX takes the kernel only on the TPU or under blocked linears;
``matmul_fused`` runs the int8 variant of its kernel under its own
``"matmul_fused_w8"`` key;
``qkv_fused`` takes three ``linear`` calls, and ``paged_attention_oproj``
the unfused pair, as in JAX.  A 1-byte page pool (``kv_cache_dtype``
fp8) sends ``paged_attention`` to ``flash_decode_fp8``.

The paper's conv path: ``conv2d`` (NHWC x HWIO -> NHWC, VALID, any
stride) is a ``torch.autograd.Function`` whose forward is the direct
blocked conv (kernel row 12) under the ``"conv2d"`` key and whose
backward is ``conv2d_dgrad`` (row 12 again, a transposed conv under
``"conv2d_dgrad"``) and ``conv2d_wgrad`` (row 13 under
``"conv2d_wgrad"``), as JAX's ``custom_vjp``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from repro_torch.kernels.conv2d_blocked import (conv2d_blocked_ref,
                                                conv2d_tiled)
from repro_torch.kernels.conv2d_bwd import conv2d_dgrad, conv2d_wgrad
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_fp8,
                                              flash_decode_oproj,
                                              paged_attention_fp8_ref,
                                              paged_attention_oproj_ref,
                                              paged_attention_ref)
from repro_torch.kernels.matmul_blocked import matmul_blocked, matmul_ref
from repro_torch.kernels.matmul_bwd import matmul_dgrad_a, matmul_dgrad_b
from repro_torch.kernels.matmul_fused import (matmul_fused as
                                              _matmul_fused_kernel,
                                              matmul_fused_ref)
from repro_torch.kernels.matmul_q import matmul_w8 as _matmul_w8_kernel
from repro_torch.kernels.matmul_q import matmul_w8_ref
from repro_torch.kernels.qkv_fused import (qkv_fused as _qkv_fused_kernel,
                                           qkv_fused_ref)
from repro_torch.quant import QuantizedTensor
from repro_torch.tune import best_schedule


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def matmul(a: torch.Tensor, b: torch.Tensor,
           tiles: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` through the blocked GEMM, with the tuned or
    model-derived tiles of the ``"matmul"`` key (``tiles`` pins them).
    Any shape launches: the kernel masks ragged edges itself.

    Differentiable: under grad, an operand that requires it gets its
    cotangent from the dgrad kernels with their own ``"matmul_dgrad"``
    tiles (explicit ``tiles`` pin the forward only, as in JAX)."""
    m, k = a.shape
    n = b.shape[1]
    bm, bk, bn = tiles or best_schedule("matmul", (m, n, k),
                                        _dtype_name(a)).tiles
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b, (bm, bk, bn))
    return matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)


def _matmul_da(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dA[M, K] = g[M, N] @ b^T under the "matmul_dgrad" key, dims in the
    (M_out, N_out, K_reduce) convention of the dA nest."""
    m, n = g.shape
    k = b.shape[0]
    bm, br, bo = best_schedule("matmul_dgrad", (m, k, n),
                               _dtype_name(g)).tiles
    return matmul_dgrad_a(g, b, bm=bm, br=br, bo=bo)


def _matmul_db(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dB[K, N] = a^T @ g[M, N] under the "matmul_dgrad" key."""
    m, k = a.shape
    n = g.shape[1]
    bk, br, bn = best_schedule("matmul_dgrad", (k, n, m),
                               _dtype_name(g)).tiles
    return matmul_dgrad_b(a, g, bk=bk, br=br, bn=bn)


class _Matmul(torch.autograd.Function):
    """The blocked GEMM with the dgrad kernels as its backward (JAX's
    ``_matmul_vjp``); each cotangent is cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b, tiles):
        ctx.save_for_backward(a, b)
        bm, bk, bn = tiles
        return matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _matmul_da(g, b).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _matmul_db(a, g).to(b.dtype)
        return da, db, None


def matmul_w8(a: torch.Tensor, w_q: torch.Tensor, scale,
              tiles: tuple[int, int, int] | None = None) -> torch.Tensor:
    """int8-weight GEMM ``a (M, K) @ (w_q (K, N) * scale)`` with the
    tuned or model-derived tiles of the ``"matmul_w8"`` key (whose model
    sizes the weight tile at one byte per element; ``tiles`` pins them).
    ``scale`` is fp32, per output channel (N,) or a scalar."""
    m, k = a.shape
    n = w_q.shape[1]
    bm, bk, bn = tiles or best_schedule("matmul_w8", (m, n, k),
                                        _dtype_name(a)).tiles
    return _matmul_w8_kernel(a, w_q, scale, bm=bm, bk=bk, bn=bn)


_BLOCKED_LINEAR: contextvars.ContextVar[bool | None] = \
    contextvars.ContextVar("repro_torch_blocked_linear", default=None)


def blocked_linear_enabled() -> bool:
    v = _BLOCKED_LINEAR.get()
    if v is None:
        return os.environ.get("REPRO_BLOCKED_LINEAR") == "1"
    return v


@contextlib.contextmanager
def blocked_linear(enable: bool = True):
    """Route model projections (``linear``) through the blocked GEMM
    while inside this context."""
    tok = _BLOCKED_LINEAR.set(bool(enable))
    try:
        yield
    finally:
        _BLOCKED_LINEAR.reset(tok)


def linear(x: torch.Tensor, w, use_kernel: bool = True) -> torch.Tensor:
    """Projection ``x @ w`` for any-rank x (w stored ``(d_in, d_out)``);
    the blocked GEMM when blocked linears are enabled
    (:func:`blocked_linear`; ``use_kernel=False``: its plain version,
    ``matmul_ref``).  Differentiable either way.

    ``w`` may be a :class:`QuantizedTensor`: a 2-D int8 one runs
    :func:`matmul_w8` (the kernel on CUDA, its plain version on the CPU;
    ``use_kernel=False`` the plain version anywhere), any other payload
    JAX's dequantized product ``x @ w.dequant()``."""
    if isinstance(w, QuantizedTensor):
        return _quantized_linear(x, w, use_kernel)
    if not blocked_linear_enabled():
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = matmul(x2, w) if use_kernel else matmul_ref(x2, w)
    return out.reshape(*lead, w.shape[-1])


def _quantized_linear(x: torch.Tensor, w: QuantizedTensor,
                      use_kernel: bool) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if w.ndim == 2 and w.dtype == torch.int8:
        if use_kernel:
            out = matmul_w8(x2, w.q, w.scale)
        else:
            out = matmul_w8_ref(x2, w.q, w.scale)
    else:
        out = (x2.float() @ w.dequant(torch.float32)).to(x.dtype)
    return out.reshape(*lead, w.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              logit_cap: float | None = None,
              use_kernel: bool = True) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq a multiple of Hkv.
    """
    fn = flash_attention if use_kernel else flash_attention_ref
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, logit_cap=logit_cap)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, window: int | None = None,
                    logit_cap: float | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Attention over a paged KV cache.

    q: (B, Hq, D) — one token per request; k/v_pages: (n_pages, page,
    Hkv, D); block_tables: (B, n_blocks) int32; lengths: (B,) int32, the
    cache length *including* the token being decoded.  Returns (B, Hq, D).

    A 4-D ``q`` of shape (B, S, Hq, D) is the multi-position form
    (chunked prefill): the S positions are consecutive, their K/V already
    scattered into the pages, and ``lengths`` counts the cache including
    the FIRST of them.  Rows fold into the kernel's group dim (``q_span =
    S``) so all S positions score in one flash-decode call over the same
    pages, each under its own causal limit.  Returns (B, S, Hq, D).

    A 1-byte pool (``float8_e4m3fn``, an fp8 KV cache) runs
    :func:`flash_decode_fp8` with the per-kv-head fp32 ``k_scale`` /
    ``v_scale`` (Hkv,), ones by default (the pure-cast cache the engine
    keeps); scales on a wide pool raise ``ValueError``, as in JAX.
    """
    multi = q.dim() == 4
    if multi:
        b, span, hq, d = q.shape
    else:
        b, hq, d = q.shape
        span = 1
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads not a multiple of {hkv}")
    g = hq // hkv
    if multi:
        # (B, S, Hq, D) -> (B, Hkv, S*G, D), rows position-major inside
        # each kv head: row r of head h is position offset r // G
        qg = (q.transpose(1, 2)
               .reshape(b, hkv, g, span, d)
               .transpose(2, 3)
               .reshape(b, hkv, span * g, d))
    else:
        qg = q.reshape(b, hkv, g, d)
    fp8 = k_pages.element_size() == 1
    if (k_scale is not None or v_scale is not None) and not fp8:
        raise ValueError("k_scale/v_scale require a 1-byte (fp8) page pool")
    if fp8:
        ones = torch.ones(hkv, dtype=torch.float32, device=q.device)
        ks = ones if k_scale is None else k_scale
        vs = ones if v_scale is None else v_scale
        fn = flash_decode_fp8 if use_kernel else paged_attention_fp8_ref
        out = fn(qg.contiguous(), k_pages, v_pages, ks, vs, block_tables,
                 lengths, window=window, logit_cap=logit_cap, q_span=span)
    else:
        fn = flash_decode if use_kernel else paged_attention_ref
        out = fn(qg.contiguous(), k_pages, v_pages, block_tables, lengths,
                 window=window, logit_cap=logit_cap, q_span=span)
    if multi:
        return (out.reshape(b, hkv, span, g, d)
                   .transpose(1, 2)
                   .reshape(b, span, hq, d))
    return out.reshape(b, hq, d)


# ------------------------------ fused ops ----------------------------------

_FUSED_OPS: contextvars.ContextVar[bool | None] = \
    contextvars.ContextVar("repro_torch_fused_ops", default=None)


def fused_ops_enabled() -> bool:
    v = _FUSED_OPS.get()
    if v is None:
        return os.environ.get("REPRO_FUSED_OPS") == "1"
    return v


@contextlib.contextmanager
def fused_ops(enable: bool = True):
    """Route the model's hot paths through the cross-op fused kernels
    while inside this context: the MLP block through
    :func:`matmul_fused`, the attention front end through
    :func:`qkv_fused` and -- where the serving engine asks -- paged
    decode through :func:`paged_attention_oproj`.  The paged engine sets
    it from its ``fuse`` flag around every model call."""
    tok = _FUSED_OPS.set(bool(enable))
    try:
        yield
    finally:
        _FUSED_OPS.reset(tok)


def matmul_fused(a: torch.Tensor, w: torch.Tensor, *,
                 bias: torch.Tensor | None = None, act: str = "none",
                 mul: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 tiles: tuple[int, int, int] | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """``act(a @ w + bias) * mul + residual`` with the epilogue fused
    into the GEMM: the output tile never round-trips through HBM between
    the reduction and its pointwise tail.  ``a`` may have any leading
    shape; ``mul`` and ``residual`` match the output's.  Tiles come from
    the ``"matmul_fused"`` key (``tiles`` pins them).

    ``w`` may be a :class:`QuantizedTensor`: a 2-D int8 one runs the
    kernel's int8 variant with its scale in the epilogue, under the
    ``"matmul_fused_w8"`` key (the fused kernel's footprint with its
    weight at one byte); any other payload is dequantized to ``a``'s
    dtype first, as in JAX."""
    scale = None
    if isinstance(w, QuantizedTensor):
        if w.ndim != 2 or w.dtype != torch.int8:
            return matmul_fused(a, w.dequant(torch.float32).to(a.dtype),
                                bias=bias, act=act, mul=mul,
                                residual=residual, tiles=tiles,
                                use_kernel=use_kernel)
        scale = w.scale.reshape(-1)
        w = w.q
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    m, k = a2.shape
    n = w.shape[-1]
    mul2 = None if mul is None else mul.reshape(m, n).contiguous()
    res2 = None if residual is None else residual.reshape(m, n).contiguous()
    if use_kernel:
        op = "matmul_fused" if scale is None else "matmul_fused_w8"
        bm, bk, bn = tiles or best_schedule(op, (m, n, k),
                                            _dtype_name(a)).tiles
        out = _matmul_fused_kernel(a2, w, scale, bias=bias, mul=mul2,
                                   residual=res2, act=act, bm=bm, bk=bk,
                                   bn=bn)
    else:
        out = matmul_fused_ref(a2, w, scale, bias=bias, mul=mul2,
                               residual=res2, act=act)
    return out.reshape(*lead, n)


def qkv_fused(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, *,
              tiles: tuple[int, int, int] | None = None,
              use_kernel: bool = True):
    """The attention front end's three projections in one launch: x
    streams from HBM once instead of three times (the bf16 kernel's
    later column blocks read it from L2).
    Returns ``(q, k, v)`` with x's leading shape.  Tiles come from the
    ``"qkv_fused"`` key, dims ``(M, Nkv, K, G)``.  Quantized weights
    take three :func:`linear` calls, as in JAX (each an int8 GEMM)."""
    if any(isinstance(w, QuantizedTensor) for w in (wq, wk, wv)):
        return (linear(x, wq, use_kernel), linear(x, wk, use_kernel),
                linear(x, wv, use_kernel))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, k = x2.shape
    nq, nkv = wq.shape[-1], wk.shape[-1]
    if use_kernel:
        bm, bk, bn = tiles or best_schedule(
            "qkv_fused", (m, nkv, k, nq // nkv), _dtype_name(x)).tiles
        q, kk, v = _qkv_fused_kernel(x2, wq, wk, wv, bm=bm, bk=bk, bn=bn)
    else:
        q, kk, v = qkv_fused_ref(x2, wq, wk, wv)
    return (q.reshape(*lead, nq), kk.reshape(*lead, nkv),
            v.reshape(*lead, nkv))


def paged_attention_oproj(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, wo: torch.Tensor, *,
                          window: int | None = None,
                          logit_cap: float | None = None,
                          use_kernel: bool = True) -> torch.Tensor:
    """Paged single-token attention with the output projection fused in.

    The contract of :func:`paged_attention` (q (B, Hq, D)) plus ``wo``,
    the dense (Hq*D, E) projection; returns (B, E).  The heads' outputs
    are reduced into the projection on chip and never reach HBM.  ``wo``
    is viewed per kv head, (Hkv, G*D, E), here, as in JAX.

    An fp8 pool or a quantized ``wo`` takes the unfused pair,
    :func:`paged_attention` then :func:`linear`, as in JAX: the fused
    kernel reads wide pages and a wide wo."""
    b, hq, d = q.shape
    if k_pages.element_size() == 1 or isinstance(wo, QuantizedTensor):
        out = paged_attention(q, k_pages, v_pages, block_tables, lengths,
                              window=window, logit_cap=logit_cap,
                              use_kernel=use_kernel)
        return linear(out.reshape(b, hq * d), wo, use_kernel)
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads not a multiple of {hkv}")
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).contiguous()
    wo3 = wo.reshape(hkv, g * d, wo.shape[-1])
    fn = flash_decode_oproj if use_kernel else paged_attention_oproj_ref
    return fn(qg, k_pages, v_pages, block_tables, lengths, wo3,
              window=window, logit_cap=logit_cap)


# -------------------------------- conv2d -----------------------------------


class _Conv2d(torch.autograd.Function):
    """The direct blocked conv with its dgrad and wgrad drivers as the
    backward (JAX's ``_conv2d_vjp``); dX is cast to x's dtype and the fp32
    dW to w's."""

    @staticmethod
    def forward(ctx, x, w, stride, tiles, use_kernel):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.use_kernel = stride, use_kernel
        if not use_kernel:
            return conv2d_blocked_ref(x, w, stride)
        bx, by, bc, bk = tiles
        return conv2d_tiled(x, w, bx=bx, by=by, bc=bc, bk=bk, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(g, w, tuple(x.shape), ctx.stride,
                              use_kernel=ctx.use_kernel).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv2d_wgrad(x, g, w.shape[0], w.shape[1], ctx.stride,
                              use_kernel=ctx.use_kernel).to(w.dtype)
        return dx, dw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           tiles: tuple[int, int, int, int] | None = None,
           use_kernel: bool = True) -> torch.Tensor:
    """Direct blocked conv, ``x (N, H, W, C)`` x ``w (Fh, Fw, C, K)`` ->
    ``(N, OH, OW, K)``, VALID padding.  The forward is kernel row 12 with
    the tuned or model-derived ``(bx, by, bc, bk)`` of the ``"conv2d"``
    key at this stride (``tiles`` pins them): level-1 spatial tiles with
    their halo as the kernel's grid, level-0 channel tiles inside.
    Differentiable: the backward runs ``conv2d_dgrad`` and
    ``conv2d_wgrad`` under their own keys (explicit ``tiles`` pin the
    forward only, as in JAX).  Any shape launches: the kernels mask
    ragged channel and spatial tiles.  ``use_kernel=False`` runs the
    plain versions, forward and backward."""
    n, h, wd, c = x.shape
    fh, fw, _, k = w.shape
    oh = (h - fh) // stride + 1
    ow = (wd - fw) // stride + 1
    if use_kernel and tiles is None:
        tiles = best_schedule("conv2d", (ow, oh, c, k, fw, fh),
                              _dtype_name(x), stride=stride).tiles
    return _Conv2d.apply(x, w, stride, tuple(tiles or ()), use_kernel)
