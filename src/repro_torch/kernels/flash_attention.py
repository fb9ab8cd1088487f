"""Streaming-softmax (flash) attention forward: CUDA kernel, wrapper and
plain version.

Port of ``repro.kernels.flash_attention._flash_forward`` (the TPU kernel
of whole-prompt prefill joins).  The kernel lives in
``csrc/flash_attention.cu`` (design and bound in its header comment): it
takes ``(B, Sq, Hq, D)`` queries against ``(B, Skv, Hkv, D)`` keys and
values with GQA indexed natively, where the JAX op vmapped a one-head
kernel over batch, kv head and group.  Causal masking, a sliding window
and a tanh logit cap are supported; ``kv_offset = Skv - Sq`` aligns the
queries to the tail of the keys.  Forward only: the ``lse`` residual the
backward needs is a later slice (training).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None) -> torch.Tensor:
    """Attention of ``(B, Sq, Hq, D)`` queries over ``(B, Skv, Hkv, D)``
    keys/values; returns ``(B, Sq, Hq, D)`` in ``q.dtype``.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`flash_attention_ref`.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap)
    b, sq, hq, d = _check(q, k, v, window)
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.load("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, sq, skv, hq, hkv, int(causal),
             int(window or 0), float(logit_cap or 0.0),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
