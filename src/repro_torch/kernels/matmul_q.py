"""Quantized-weight GEMM: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.matmul_q.matmul_w8`` (kernel row 10):
``C[M, N] = A[M, K] @ (Wq[K, N] * scale[N])`` with A in fp32 or bf16, Wq
int8 and an fp32 per-output-channel (or per-tensor) scale.  The kernels
live in ``csrc/matmul_w8.cu`` (design and bound in its header comment;
the ``"mma"`` instance in ``csrc/matmul_w8_mma.cu``, a library of its
own so that the two build in parallel): the weight tile staged at one
byte per element, the fp32 sum of ``a * q`` over the whole K extent, and
the scale applied once at the store -- the TPU kernel's order, and
:func:`matmul_w8_ref`'s.  Three instances
(``matmul_fused.instance_kind``):

* fp32, ``"fma"``: the tile core of ``matmul_blocked``, the int8 tile
  widened to fp32 at the multiply-add;
* bf16, ``"mma_t"`` (M <= 16) and ``"mma"`` (M > 16): row 9's
  tensor-core instances (``csrc/gemm_mma_inst.cuh``) with its int8
  staging: raw rows widened exactly to bf16 on chip.

Tiles come from the ``"matmul_w8"`` schedule key, whose model prices the
weight stream at one byte; :func:`smem_bytes_required` mirrors the
instance the Hopper adapter checks its candidates against (in bf16 row
9's, so the key takes row 9's int8 tiles: at M <= 16 a decode tile whose
column blocks fill the card).

An int8 row of N bytes is staged 16 columns per 16-byte copy, so N and
the tile's bn must be multiples of 16 (granite's 1024, 4096 and 12800
are); the wrapper raises otherwise.  Ragged M and K are masked in the
kernel.  Forward only.  The wrapper records what ran in
``matmul_w8.instance``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels import matmul_fused as MF

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def smem_bytes_required(bm: int, bk: int, bn: int, a_bytes: int = 2,
                        w_bytes: int = 1, *, m: int | None = None) -> int:
    """Dynamic shared memory of one block of the instance that runs ``m``
    rows (None: an ``"mma"``-sized M): fp32, the tile core's A tile at
    ``a_bytes`` and weight tile at ``w_bytes`` per element, two stages
    deep; bf16, row 9's instance with its int8 weight.  The per-column
    scale is read at the store, not staged."""
    if a_bytes != 2:
        return MB.smem_bytes_required(bm, bk, bn, a_bytes, w_bytes)
    return MF.smem_bytes_required(bm, bk, bn, 2, w_bytes, m=m)


def hbm_bytes(M: int, N: int, K: int, bm: int, bk: int, bn: int,
              a_bytes: int = 2, w_bytes: int = 1) -> int:
    """Global-memory bytes one call's grid requests: the GEMM's with the
    weight stream at ``w_bytes`` (``matmul_fused.hbm_bytes``) plus the
    fp32 scale, which ``W8Map::store`` loads for every output element
    (``csrc/gemm_mma_inst.cuh``; a per-tensor scale is broadcast to a
    row of N by the wrapper).  JAX's count fetches the scale row once
    per row block."""
    return MF.hbm_bytes(M, N, K, bm, bk, bn, a_bytes, w_bytes)


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
    in ``a``'s dtype.  The bf16 instances keep
    ``matmul_fused.mma_stages`` (``"mma"``) or ``MMA_T_STAGES``
    (``"mma_t"``) reduction steps in flight.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_w8_ref`.
    """
    if a.device.type == "cpu":
        return matmul_w8_ref(a, w_q, scale)
    MB._check(a, w_q, bm, bk, bn, name="matmul_w8", int8_b=True,
              core_tiles=a.dtype != torch.bfloat16)
    m, k = a.shape
    n = w_q.shape[1]
    stages = MF.check_tiles(a.dtype, m, (bm, bk, bn), True,
                            torch.cuda.get_device_properties(
                                a.device).shared_memory_per_block_optin)
    s = MB.fp32_row(scale, n, "scale", a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = ("matmul_w8_mma" if MF.instance_kind(a.dtype, m) == "mma"
           else "matmul_w8")
    fn = _build.load(lib, f"{lib}_fwd", _ARGTYPES)
    err = fn(MB._DTYPES[a.dtype], a.data_ptr(), w_q.data_ptr(),
             s.data_ptr(), out.data_ptr(), m, n, k, bm, bk, bn, stages,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_w8")
    matmul_w8.launches += 1
    matmul_w8.instance = MF.instance(a.dtype, m, bm, bn, stages)
    return out


matmul_w8.launches = 0
matmul_w8.instance = None   # ("mma" | "mma_t" | "fma", layout, stages)
