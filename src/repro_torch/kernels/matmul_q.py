"""Quantized-weight GEMM: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.matmul_q.matmul_w8`` (kernel row 10):
``C[M, N] = A[M, K] @ (Wq[K, N] * scale[N])`` with A in fp32 or bf16, Wq
int8 and an fp32 per-output-channel (or per-tensor) scale.  The kernel
lives in ``csrc/matmul_w8.cu`` (design and bound in its header comment):
the tile core of ``matmul_blocked`` with the weight tile staged at one
byte per element, the fp32 accumulator summing ``a * q`` over the whole
K extent, and the scale applied once in the epilogue -- the TPU
kernel's order, and :func:`matmul_w8_ref`'s.  Tiles come from the
``"matmul_w8"`` schedule key, whose model prices the weight stream at
one byte (:func:`smem_bytes_required` is what the Hopper adapter checks
its candidates against).

An int8 row of N bytes is staged 16 columns per 16-byte copy, so N and
the tile's bn must be multiples of 16 (granite's 1024, 4096 and 12800
are); the wrapper raises otherwise.  Ragged M and K are masked in the
kernel.  Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def smem_bytes_required(bm: int, bk: int, bn: int, a_bytes: int = 2,
                        w_bytes: int = 1) -> int:
    """Dynamic shared memory of one block: the A tile at ``a_bytes`` and
    the weight tile at ``w_bytes`` per element, two stages deep (the
    per-column scale is read at the store, not staged)."""
    return MB.smem_bytes_required(bm, bk, bn, a_bytes, w_bytes)


def matmul_w8_ref(a: torch.Tensor, w_q: torch.Tensor,
                  scale) -> torch.Tensor:
    """Plain version: the fp32 product of ``a`` and the int8 payload,
    then the scale, one cast -- the kernel's order.  (JAX's CPU
    ``linear`` computes ``a @ (q * s)``; at fp32 the two agree to about
    1e-6.)"""
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=a.device).reshape(1, -1)
    return ((a.float() @ w_q.float()) * s).to(a.dtype)


def matmul_w8(a: torch.Tensor, w_q: torch.Tensor, scale, *, bm: int,
              bk: int, bn: int) -> torch.Tensor:
    """``a (M, K) @ (w_q (K, N) * scale)`` tiled ``(bm, bk, bn)``; output
    in ``a``'s dtype.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_w8_ref`.
    """
    if a.device.type == "cpu":
        return matmul_w8_ref(a, w_q, scale)
    MB._check(a, w_q, bm, bk, bn, name="matmul_w8", int8_b=True)
    m, k = a.shape
    n = w_q.shape[1]
    s = MB.fp32_row(scale, n, "scale", a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = _build.load("matmul_w8", "matmul_w8_fwd", _ARGTYPES)
    err = fn(MB._DTYPES[a.dtype], a.data_ptr(), w_q.data_ptr(),
             s.data_ptr(), out.data_ptr(), m, n, k, bm, bk, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_w8")
    matmul_w8.launches += 1
    return out


matmul_w8.launches = 0
