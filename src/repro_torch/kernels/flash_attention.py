"""Streaming-softmax (flash) attention forward: CUDA kernel, wrapper and
plain version.

Port of ``repro.kernels.flash_attention._flash_forward`` (the TPU kernel
of whole-prompt prefill joins).  The kernel lives in
``csrc/flash_attention.cu`` (design and bound in its header comment): it
takes ``(B, Sq, Hq, D)`` queries against ``(B, Skv, Hkv, D)`` keys and
values with GQA indexed natively, where the JAX op vmapped a one-head
kernel over batch, kv head and group.  Causal masking, a sliding window
and a tanh logit cap are supported; ``kv_offset = Skv - Sq`` aligns the
queries to the tail of the keys.  Two instances: bf16 runs on the
tensor cores (``mma.sync``, ``csrc/attn_mma.cuh``; P is rounded to bf16
before its product with V), fp32 on CUDA cores (``csrc/attn_rows.cuh``).
Both are tiled ``(block_q, block_kv)`` by the Hopper ``flash_tiles``,
which the backward shares; :func:`fwd_smem_bytes` and
:func:`fwd_accumulators` mirror the ``.cu``.  The wrapper records the
instance it launched in ``flash_attention.instance``.

Differentiable: when grad is on and an input requires it, the op runs as
a ``torch.autograd.Function`` (the counterpart of JAX's
``_make_differentiable``), whose forward also writes the per-row
``lse = m + log(l)`` residual (fp32, ``(B, Hq, Sq)``; 1e30 for a row that
sees no key) and saves ``(q, k, v, o, lse)``, and whose backward is the
recompute kernel of ``kernels/flash_attention_bwd.py`` (kernel row 5).
On CPU tensors both halves are the plain versions.  Without grad the
serving path launches the forward alone, without the residual.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hopper_adapter import flash_tiles
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
BIG = 1e30  # the lse of a row that sees no key: exp(s - BIG) == 0
# block_q and block_kv of the tensor-core instances: one m16 row tile per
# warp, one to four warps (block_q), and whole k16 steps (block_kv); the
# .cu instantiates exactly these
MMA_TILES = (16, 32, 64)
ROWS_PER_WARP = 16       # the m16 tile a warp owns
CUDA_CORE_ROWS = 4       # fp32 instances: query rows (or keys) per block


def fwd_smem_bytes(block_q: int, block_kv: int, head_dim: int,
                   bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one forward block (csrc:
    ``attn_mma::fwd_smem_bytes``, ``attn::smem_bytes``).  bf16: K and V
    tiles of ``block_kv`` keys, two stages each, and the block's
    ``block_q`` q rows, staged in the second stage where they fit (they
    go to registers before the first copy into it).  fp32: K and V
    tiles, two stages each, the block's 4 q rows and one fp32 score per
    key for each."""
    if bytes_per_elem == 2:
        q_rows = 0 if block_q <= 2 * block_kv else block_q
        return (2 * 2 * block_kv + q_rows) * head_dim * 2
    return (2 * 2 * block_kv * head_dim * bytes_per_elem
            + CUDA_CORE_ROWS * head_dim * bytes_per_elem
            + CUDA_CORE_ROWS * block_kv * 4)


def fwd_accumulators(block_q: int, block_kv: int, head_dim: int) -> int:
    """fp32 sums a thread of the bf16 forward holds: its warp's m16 x D
    output and m16 x block_kv scores, over 32 lanes."""
    return ROWS_PER_WARP * (head_dim + block_kv) // 32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        logit_cap: float | None = None) -> torch.Tensor:
    """Plain version: dense masked softmax in fp32 per (batch, head).
    q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qh = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)  # B,Hkv,G,Sq,D
    kh = k.permute(0, 2, 1, 3)[:, :, None]                   # B,Hkv,1,Skv,D
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    out = attention_ref(qh, kh, vh, causal=causal, logit_cap=logit_cap,
                        window=window)                        # B,Hkv,G,Sq,D
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def dense_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                 window: int | None, logit_cap: float | None):
    """The scores of every (query row, key) pair in fp32, in the GQA
    layout ``(B, Hkv, G, Sq, Skv)``: ``(s, t, mask)`` with ``s`` capped
    (``cap * t``, ``t = tanh(s_pre / cap)``; ``t`` is None without a
    cap) and ``mask`` the visible pairs (Sq, Skv).  Shared by the plain
    lse and the plain backward."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qh = q.float().reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5
    t = None
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s, t, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            logit_cap: float | None = None) -> torch.Tensor:
    """Plain version of the forward's residual: ``lse = log sum exp s``
    over the visible keys of each row, fp32 ``(B, Hq, Sq)``, ``BIG`` for
    a row that sees none."""
    b, sq, hq, _ = q.shape
    s, _, mask = dense_scores(q, k, causal=causal, window=window,
                              logit_cap=logit_cap)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    lse = torch.where(mask.any(-1), lse, torch.full_like(lse, BIG))
    return lse.reshape(b, hq, sq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None) -> torch.Tensor:
    """Attention of ``(B, Sq, Hq, D)`` queries over ``(B, Skv, Hkv, D)``
    keys/values; returns ``(B, Sq, Hq, D)`` in ``q.dtype``.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`flash_attention_ref`.  With grad on and an
    input requiring it, the op is differentiable through the backward
    kernel (module docstring).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, logit_cap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap)
    return _forward(q, k, v, causal, window, logit_cap, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.instance = None   # (kind, block_q, block_kv) of the last


def instance_kind(dtype: torch.dtype) -> str:
    """The instance a CUDA tensor of ``dtype`` launches: ``"mma"`` (bf16,
    tensor cores) or ``"cuda_core"`` (fp32)."""
    return "mma" if dtype == torch.bfloat16 else "cuda_core"


def check_tiles(tiles: tuple[int, int], dtype: torch.dtype
                ) -> tuple[int, int]:
    """``(block_q, block_kv)`` as given, or raise where the instance for
    ``dtype`` has no such tiles (bf16: both in :data:`MMA_TILES`)."""
    block_q, block_kv = tiles
    if dtype == torch.bfloat16 and not {block_q, block_kv} <= set(MMA_TILES):
        raise ValueError(f"tiles {tiles}: the tensor-core instance takes "
                         f"block_q and block_kv in {MMA_TILES}")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"tiles {tiles} must be positive")
    return block_q, block_kv


def _forward(q, k, v, causal, window, logit_cap, with_lse):
    """Launch the forward kernel, tiled by the Hopper ``flash_tiles``;
    ``(out, lse or None)``."""
    b, sq, hq, d = _check(q, k, v, window)
    skv, hkv = k.shape[1], k.shape[2]
    block_q, block_kv = check_tiles(
        flash_tiles(sq, skv, d, q.element_size()), q.dtype)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.load("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, sq,
             skv, hq, hkv, int(causal), int(window or 0),
             float(logit_cap or 0.0), block_q, block_kv,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.instance = (instance_kind(q.dtype), block_q, block_kv)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward with the lse residual, recompute backward (kernel row 5);
    on CPU tensors the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, window=window, logit_cap=logit_cap)
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, **kw)
            lse = flash_attention_lse_ref(q, k, **kw)
        else:
            out, lse = _forward(q, k, v, causal, window, logit_cap,
                                with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.flash_attention_bwd import \
            flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None


def _check(q, k, v, window):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must share "
                            f"one of {sorted(map(str, _DTYPES))}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16-byte vectors)")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads not a multiple of {k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    return b, sq, hq, d
