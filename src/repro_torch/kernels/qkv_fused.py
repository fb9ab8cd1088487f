"""Fused QKV projection: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.qkv_fused.qkv_fused`` (kernel row 11): the
attention front end's three projections in one pass over the activation,
so x crosses the HBM boundary once instead of three times.  The kernel
lives in ``csrc/qkv_fused.cu`` (design and bound in its header comment):
one GEMM over a joint tile of ``(G + 2) * bn`` columns -- a ``G * bn``
wide q block beside ``bn`` wide k and v blocks, as on the TPU -- run by
the tile core of ``matmul_blocked``, whose footprint and accumulator cap
therefore apply to the joint width.  Ragged edges are masked: every
shape launches.

Layouts: x (M, K); wq (K, G * Nkv); wk, wv (K, Nkv), G = Hq / Hkv.  The
tiles ``(bm, bk, bn)`` block the per-projection width Nkv (the
``"qkv_fused"`` schedule key, dims ``(M, Nkv, K, G)``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def joint_cols(bn: int, groups: int) -> int:
    """Output columns of one block's tile: a (G * bn) q block and two
    bn-wide k and v blocks."""
    return (groups + 2) * bn


def smem_bytes_required(bm: int, bk: int, bn: int, groups: int,
                        bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one block: the tile core's staged A tile
    and joint B tile."""
    return MB.smem_bytes_required(bm, bk, joint_cols(bn, groups),
                                  bytes_per_elem)


def accumulators_per_thread(bm: int, bn: int, groups: int) -> int:
    """fp32 accumulators each thread holds for the joint (bm, (G+2)*bn)
    output tile (``matmul_blocked.accumulators_per_thread``)."""
    return MB.accumulators_per_thread(bm, joint_cols(bn, groups))


def qkv_fused_ref(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                  wv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version: three fp32 products, each cast to x's dtype."""
    return tuple(MB.matmul_ref(x, w) for w in (wq, wk, wv))


def qkv_fused(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, *, bm: int, bk: int,
              bn: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x @ wq, x @ wk, x @ wv)`` in one pass over x, tiled
    ``(bm, bk, bn)`` with ``bn`` blocking Nkv; any M, Nkv, K.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`qkv_fused_ref`.
    """
    if x.device.type == "cpu":
        return qkv_fused_ref(x, wq, wk, wv)
    if wk.shape != wv.shape or wq.dim() != 2 or wk.dim() != 2 \
            or wq.shape[0] != wk.shape[0] or wq.shape[1] % wk.shape[1]:
        raise ValueError(f"wq {tuple(wq.shape)}, wk {tuple(wk.shape)} and "
                         f"wv {tuple(wv.shape)} are not (K, G*Nkv), (K, Nkv)"
                         " and (K, Nkv)")
    nkv = wk.shape[1]
    g = wq.shape[1] // nkv
    for w in (wq, wk, wv):
        MB._check(x, w, bm, bk, bn, name="qkv_fused",
                  n_cols=joint_cols(bn, g))
    m, k = x.shape
    q = torch.empty((m, g * nkv), dtype=x.dtype, device=x.device)
    kk = torch.empty((m, nkv), dtype=x.dtype, device=x.device)
    v = torch.empty((m, nkv), dtype=x.dtype, device=x.device)
    fn = _build.load("qkv_fused", "qkv_fused_fwd", _ARGTYPES)
    err = fn(MB._DTYPES[x.dtype], x.data_ptr(), wq.data_ptr(),
             wk.data_ptr(), wv.data_ptr(), q.data_ptr(), kk.data_ptr(),
             v.data_ptr(), m, nkv, k, g, bm, bk, bn,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qkv_fused")
    qkv_fused.launches += 1
    return q, kk, v


qkv_fused.launches = 0
