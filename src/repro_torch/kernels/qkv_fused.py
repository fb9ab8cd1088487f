"""Fused QKV projection: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.qkv_fused.qkv_fused`` (kernel row 11): the
attention front end's three projections in one launch.  The kernels live
in ``csrc/qkv_fused.cu`` (design and bound in its header comment; the
``"mma"`` instance in ``csrc/qkv_fused_mma.cu``, a library of its own so
that the two build in parallel).  Ragged edges are masked: every shape
launches.  Three instances (``matmul_fused.instance_kind``):

* fp32, ``"fma"``: one GEMM over a joint tile of ``(G + 2) * bn``
  columns -- a ``G * bn`` wide q block beside ``bn`` wide k and v
  blocks, as on the TPU, so one staged x tile feeds all three weights --
  run by the tile core of ``matmul_blocked``, whose footprint and
  accumulator cap therefore apply to the joint width;
* bf16, ``"mma_t"`` (M <= 16) and ``"mma"`` (M > 16): row 9's
  tensor-core instances (``csrc/gemm_mma_inst.cuh``) over a
  segment-major grid: each block owns ``bn`` columns of one projection
  (the q blocks, then the k blocks, then the v blocks; :func:`blocks`)
  and reads its own weight, so its footprint is row 9's at ``(bm, bk,
  bn)`` (``matmul_fused.smem_bytes_required``).  At decode the
  ``"qkv_fused"`` key's tile makes :func:`blocks` fill the card.

Layouts: x (M, K); wq (K, G * Nkv); wk, wv (K, Nkv), G = Hq / Hkv.  The
tiles ``(bm, bk, bn)`` block the per-projection width Nkv (the
``"qkv_fused"`` schedule key, dims ``(M, Nkv, K, G)``).  The wrapper
records what ran in ``qkv_fused.instance``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels import matmul_fused as MF

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])


def joint_cols(bn: int, groups: int) -> int:
    """Output columns of one fp32 block's tile: a (G * bn) q block and two
    bn-wide k and v blocks."""
    return (groups + 2) * bn


def blocks(nkv: int, groups: int, bn: int) -> int:
    """Column blocks of the bf16 instances' segment-major grid:
    ``ceil(G Nkv / bn)`` q blocks, then ``ceil(Nkv / bn)`` k and as many
    v blocks."""
    return -(-groups * nkv // bn) + 2 * -(-nkv // bn)


def hbm_bytes(M: int, Nkv: int, K: int, groups: int, bm: int, bk: int,
              bn: int, bytes_per_elem: int = 2) -> int:
    """Global-memory bytes one call's grid requests: x read once per
    column block (fp32: the ``ceil(Nkv / bn)`` joint blocks, each
    feeding all three weights from one staged tile; bf16: the
    segment-major grid's :func:`blocks`), the three weights once per row
    block (``matmul_blocked.row_blocks``: one for the decode instance),
    q, k and v written once.  ``bk`` does not change the count.  JAX's
    count has the TPU's joint tile in every dtype, and elides x's
    re-reads when the reduction is one block."""
    del bk
    cols = (groups + 2) * Nkv
    col_blocks = (-(-Nkv // bn) if bytes_per_elem != 2
                  else blocks(Nkv, groups, bn))
    gm = MB.row_blocks(M, bm, bytes_per_elem)
    return (M * K * col_blocks + K * cols * gm + M * cols) * bytes_per_elem


def smem_bytes_required(bm: int, bk: int, bn: int, groups: int,
                        bytes_per_elem: int = 2, *,
                        m: int | None = None) -> int:
    """Dynamic shared memory of one block of the instance that runs ``m``
    rows (None: an ``"mma"``-sized M): fp32, the tile core's staged A
    tile and joint B tile; bf16, row 9's instance at the (bm, bk, bn)
    tile of one projection."""
    if bytes_per_elem != 2:
        return MB.smem_bytes_required(bm, bk, joint_cols(bn, groups),
                                      bytes_per_elem)
    return MF.smem_bytes_required(bm, bk, bn, 2, m=m)


def accumulators_per_thread(bm: int, bn: int, groups: int,
                            bytes_per_elem: int = 2, *,
                            m: int | None = None) -> int:
    """fp32 sums each thread holds: fp32, the tile core's for the joint
    (bm, (G+2)*bn) output tile; bf16, row 9's instance's for (bm, bn)."""
    if bytes_per_elem != 2:
        return MB.accumulators_per_thread(bm, joint_cols(bn, groups))
    return MF.accumulators_per_thread(bm, bn, 2, m=m)


def qkv_fused_ref(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                  wv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version: three fp32 products, each cast to x's dtype."""
    return tuple(MB.matmul_ref(x, w) for w in (wq, wk, wv))


def qkv_fused(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, *, bm: int, bk: int,
              bn: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x @ wq, x @ wk, x @ wv)`` in one launch, tiled ``(bm, bk, bn)``
    with ``bn`` blocking Nkv; any M, Nkv, K.  The bf16 instances keep
    ``matmul_fused.mma_stages`` (``"mma"``) or ``MMA_T_STAGES``
    (``"mma_t"``) reduction steps in flight.

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
    core = x.dtype != torch.bfloat16
    for w in (wq, wk, wv):
        MB._check(x, w, bm, bk, bn, name="qkv_fused",
                  n_cols=joint_cols(bn, g), core_tiles=core)
    m, k = x.shape
    stages = MF.check_tiles(x.dtype, m, (bm, bk, bn), False,
                            torch.cuda.get_device_properties(
                                x.device).shared_memory_per_block_optin)
    q = torch.empty((m, g * nkv), dtype=x.dtype, device=x.device)
    kk = torch.empty((m, nkv), dtype=x.dtype, device=x.device)
    v = torch.empty((m, nkv), dtype=x.dtype, device=x.device)
    lib = ("qkv_fused_mma" if MF.instance_kind(x.dtype, m) == "mma"
           else "qkv_fused")
    fn = _build.load(lib, f"{lib}_fwd", _ARGTYPES)
    err = fn(MB._DTYPES[x.dtype], x.data_ptr(), wq.data_ptr(),
             wk.data_ptr(), wv.data_ptr(), q.data_ptr(), kk.data_ptr(),
             v.data_ptr(), m, nkv, k, g, bm, bk, bn, stages,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qkv_fused")
    qkv_fused.launches += 1
    qkv_fused.instance = MF.instance(x.dtype, m, bm,
                                     joint_cols(bn, g) if core else bn,
                                     stages)
    return q, kk, v


qkv_fused.launches = 0
qkv_fused.instance = None   # ("mma" | "mma_t" | "fma", layout, stages)
