"""Epilogue-fused blocked GEMM: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.matmul_fused.matmul_fused`` (kernel row 9), for
wide and int8 weights: ``Y = act(A @ W * scale + bias) * mul +
residual`` in one kernel, so the output tile's pointwise tail never
round-trips through HBM.  The kernel lives in ``csrc/matmul_fused.cu``
(design and bound in its header comment; the ``"mma"`` instance in
``csrc/matmul_fused_mma.cu``, a library of its own so that the two build
in parallel): the epilogue is applied in fp32
to each output element after the last k step, with one cast at the end;
its operands are read into registers at the store, not staged.  Ragged
edges are masked: every shape launches.  Three instances
(:func:`instance_kind`):

* fp32, ``"fma"``: ``matmul_blocked``'s CUDA-core tile core (TF32 would
  break the fp32 tolerances), its footprint and accumulators;
* bf16 with M > 16, ``"mma"``: the tensor cores, on ``gemm_mma.cuh``'s
  fragment core at the warp grid ``matmul_bwd.mma_layout`` of the
  ``(bm, bn)`` tile, 2 or 3 reduction steps in flight
  (:func:`mma_stages`);
* bf16 with M <= 16, ``"mma_t"``: decode, the transposed product
  ``Y^T = W^T A^T``: ``bn`` (16, 32, 64 or 128) columns of W on the m16
  side, the M tokens one or two n8 tiles, the 8 warps splitting each
  step's k16 steps and summing in warp order; :data:`MMA_T_STAGES` steps
  in flight.  The block holds all M rows (``bm`` does not enter), and
  the ``"matmul_fused"`` key's decode tile makes ``ceil(N / bn)`` fill
  the card.

The ``"matmul_fused"`` key has its own footprint (:func:`fused_fits` in
``core.hopper_adapter``, over :func:`smem_bytes_required` and
:func:`accumulators_per_thread`); it ranks the ``"matmul"`` candidates
only in fp32.  An int8 ``W`` (JAX ``ops.matmul_fused`` with a
``QuantizedTensor``; its dequantisation scale in ``scale``) runs the same
kernels (``matmul_fused_w8_fwd``, ``matmul_fused_mma_w8_fwd``) with the
weight staged at one byte per element and widened to bf16 (exactly) or
fp32 on chip, under its own ``"matmul_fused_w8"`` key.  N and bn must then be multiples of 16.  The
wrapper records what ran in ``matmul_fused.instance``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.hopper_adapter import default_smem_budget
from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels.matmul_bwd import (MAX_FRAGMENTS, MAX_M_TILES,
                                            MAX_N_TILES, MMA_M, MMA_N,
                                            K_STEP, WARPS, mma_layout,
                                            staged_chunks)

ACTIVATIONS = {
    "none": lambda y: y,
    "relu": torch.relu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),   # jax.nn.gelu
    "silu": F.silu,
}
_ACT_IDS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}   # csrc: enum Act
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])

MMA_T_ROWS = 16            # "mma_t" holds up to this many tokens
MMA_T_COLS = (16, 32, 64, 128)   # "mma_t": bn, MT = bn / 16 m16 tiles
MMA_T_STAGES = 4           # "mma_t": reduction steps in flight
DECODE_BLOCKS = 128        # the decode tile's least ceil(N / bn)
DECODE_W_BYTES = 64 * 1024  # the decode tile's W bytes over its stages


def instance_kind(dtype: torch.dtype, m: int) -> str:
    """The instance a CUDA launch of ``dtype`` with ``m`` rows runs:
    ``"fma"`` (fp32), ``"mma"`` (bf16, m > 16) or ``"mma_t"`` (bf16,
    m <= 16)."""
    if dtype != torch.bfloat16:
        return "fma"
    return "mma_t" if m <= MMA_T_ROWS else "mma"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def token_tiles(m: int) -> int:
    """The n8 tiles of tokens ``"mma_t"`` stages: 1 for m <= 8, else 2."""
    return 1 if m <= MMA_N else 2


def _mma_smem(rows: int, bk: int, bn: int, stages: int, w8: bool) -> int:
    """csrc ``mma_smem``: ``stages`` buffers of ``rows`` A rows of a
    k16-rounded step (swizzled chunks, ``staged_chunks``) and a step of W
    (swizzled bf16 chunks, or raw int8 rows of ``bn / 16`` chunks), and
    for an int8 W one widened bf16 tile."""
    bkp = _ceil(bk, K_STEP) * K_STEP
    tx = staged_chunks(bkp // 8)[0]
    tw = staged_chunks(_ceil(bn, 8))[0]
    w_chunks = bkp * (bn // 16) if w8 else bkp * tw
    return (stages * (rows * tx + w_chunks) + (bkp * tw if w8 else 0)) * 16


def mma_stages(bm: int, bk: int, bn: int, w_bytes: int | None = None) -> int:
    """``"mma"``'s reduction steps in flight at these tiles: three where
    they fit the two-block budget (115,712 B), else two (the dgrad's
    rule, ``matmul_bwd.mma_stages``)."""
    w8 = w_bytes == 1
    return 3 if _mma_smem(bm, bk, bn, 3, w8) <= default_smem_budget() else 2


def smem_bytes_required(bm: int, bk: int, bn: int,
                        bytes_per_elem: int = 2,
                        w_bytes: int | None = None, *, m: int | None = None,
                        stages: int | None = None) -> int:
    """Dynamic shared memory of one block of the instance that runs ``m``
    rows (None: an ``"mma"``-sized M) at these tiles.  fp32:
    ``matmul_blocked``'s staged A and B tiles (B at ``w_bytes``: 1 for an
    int8 weight).  bf16: :func:`_mma_smem` at the instance's stages
    (default :func:`mma_stages`, :data:`MMA_T_STAGES`), ``"mma_t"`` with
    its token rows for ``bm`` and at least its warps' (bn, 8 NT) fp32
    sums, which overlay the stages.  No epilogue operand is staged."""
    if bytes_per_elem != 2:
        return MB.smem_bytes_required(bm, bk, bn, bytes_per_elem, w_bytes)
    w8 = w_bytes == 1
    if m is not None and m <= MMA_T_ROWS:
        nt = token_tiles(m)
        sums = WARPS * (bn // 16) * nt * 4 * 32 * 4
        return max(sums, _mma_smem(MMA_N * nt, bk, bn,
                                   stages or MMA_T_STAGES, w8))
    return _mma_smem(bm, bk, bn, stages or mma_stages(bm, bk, bn, w_bytes),
                     w8)


def accumulators_per_thread(bm: int, bn: int, bytes_per_elem: int = 2, *,
                            m: int | None = None) -> int:
    """fp32 sums a thread holds: fp32, ``matmul_blocked``'s; ``"mma"``,
    four per fragment of ``mma_layout(bm, bn)`` (above the limit where no
    grid holds the tile); ``"mma_t"``, four per (bn / 16) x NT fragments
    a warp holds."""
    if bytes_per_elem != 2:
        return MB.accumulators_per_thread(bm, bn)
    if m is not None and m <= MMA_T_ROWS:
        return 4 * _ceil(bn, MMA_M) * token_tiles(m)
    layout = mma_layout(bm, bn)
    if layout is None:
        return 4 * _ceil(bm, MMA_M) * _ceil(bn, MMA_N)
    return 4 * layout[2] * layout[3]


def hbm_bytes(M: int, N: int, K: int, bm: int, bk: int, bn: int,
              bytes_per_elem: int = 2, w_bytes: int | None = None,
              has_bias: bool = False, has_mul: bool = False,
              has_residual: bool = False) -> int:
    """Global-memory bytes one call's grid requests: the GEMM's
    (``matmul_blocked.hbm_bytes``: A once per column block, W at
    ``w_bytes`` -- 1 for an int8 weight -- once per row block, Y written
    once) plus the epilogue's operands, which ``FusedMap::store`` loads
    for every output element (``csrc/fused_gemm.cuh``): the fp32 scale
    (int8 W) and bias, and ``mul`` and ``residual`` in A's dtype.  JAX's
    count fetches the fp32 rows once per row block under DMA elision;
    here each element's load is a request (L2 serves the repeats)."""
    del bk
    gm = MB.row_blocks(M, bm, bytes_per_elem)
    wb = bytes_per_elem if w_bytes is None else w_bytes
    total = (M * K * bytes_per_elem * _ceil(N, bn) + K * N * wb * gm
             + M * N * bytes_per_elem)
    per_out = (4 * ((w_bytes is not None) + has_bias)
               + bytes_per_elem * (has_mul + has_residual))
    return total + M * N * per_out


def matmul_fused_ref(a: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     mul: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None, *,
                     act: str = "none") -> torch.Tensor:
    """Plain version, in the order of the JAX oracle: the fp32 product,
    then scale, bias, activation, mul and residual in fp32, one cast."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    y = a.float() @ w.float()
    if scale is not None:
        y = y * torch.as_tensor(scale, dtype=torch.float32,
                                device=y.device).reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    y = ACTIVATIONS[act](y)
    if mul is not None:
        y = y * mul.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(a.dtype)


def matmul_fused(a: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 mul: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None, *,
                 act: str = "none", bm: int, bk: int,
                 bn: int) -> torch.Tensor:
    """``act(a (M, K) @ w (K, N) * scale + bias) * mul + residual`` tiled
    ``(bm, bk, bn)``; any M, N, K (an int8 ``w``: N and bn multiples of
    16).  ``w`` is in ``a``'s dtype or int8 (then ``scale`` is its
    dequantisation scale).  ``scale`` (N,) or a scalar and ``bias`` (N,)
    are taken in fp32; ``mul`` and ``residual`` are (M, N) in ``a``'s
    dtype.  The bf16 instances keep :func:`mma_stages` (``"mma"``) or
    :data:`MMA_T_STAGES` (``"mma_t"``) reduction steps in flight.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_fused_ref`.
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if a.device.type == "cpu":
        return matmul_fused_ref(a, w, scale, bias, mul, residual, act=act)
    int8 = w.dtype == torch.int8
    MB._check(a, w, bm, bk, bn, name="matmul_fused", int8_b=int8,
              core_tiles=a.dtype != torch.bfloat16)
    m, k = a.shape
    n = w.shape[1]
    stages = check_tiles(a.dtype, m, (bm, bk, bn), int8,
                         torch.cuda.get_device_properties(
                             a.device).shared_memory_per_block_optin)
    rows = {name: MB.fp32_row(t, n, name, a.device)
            for name, t in (("scale", scale), ("bias", bias))
            if t is not None}
    for name, t in (("mul", mul), ("residual", residual)):
        if t is None:
            continue
        if t.device != a.device or t.dtype != a.dtype:
            raise TypeError(f"{name} must be on {a.device} in {a.dtype}; "
                            f"got {t.device}, {t.dtype}")
        if tuple(t.shape) != (m, n) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({m}, {n}); got "
                             f"{tuple(t.shape)}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    kind = instance_kind(a.dtype, m)
    lib = "matmul_fused_mma" if kind == "mma" else "matmul_fused"
    fn = _build.load(lib, f"{lib}_w8_fwd" if int8 else f"{lib}_fwd",
                     _ARGTYPES)
    err = fn(MB._DTYPES[a.dtype], a.data_ptr(), w.data_ptr(),
             out.data_ptr(), ptr(rows.get("scale")), ptr(rows.get("bias")),
             ptr(mul), ptr(residual), _ACT_IDS[act], m, n, k, bm, bk, bn,
             stages, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    matmul_fused.instance = instance(a.dtype, m, bm, bn, stages)
    return out


matmul_fused.launches = 0
matmul_fused.instance = None   # ("mma" | "mma_t" | "fma", layout, stages)


def instance(dtype: torch.dtype, m: int, bm: int, bn: int,
             stages: int) -> tuple:
    """What a launch runs: ``("mma", (wm, wn, mt, nt), stages)``,
    ``("mma_t", (bn / 16, token n8 tiles), stages)`` or ``("fma", rows a
    thread holds, stages)``."""
    kind = instance_kind(dtype, m)
    if kind == "mma":
        return kind, mma_layout(bm, bn), stages
    if kind == "mma_t":
        return kind, (bn // MMA_M, token_tiles(m)), stages
    return kind, MB.accumulators_per_thread(bm, bn) // MB.COLS_PER_THREAD, \
        stages


def check_tiles(dtype: torch.dtype, m: int, tiles: tuple[int, int, int],
                int8: bool, optin_bytes: int) -> int:
    """The stage count the instance for (``dtype``, ``m`` rows) launches
    at ``tiles``, or raise where it does not hold them: ``"mma_t"``, bn in
    :data:`MMA_T_COLS`; ``"mma"``, a warp grid of ``mma_layout``;
    ``"fma"`` (two stages), the tile core's own limits
    (``matmul_blocked._check``); each, its shared memory within
    ``optin_bytes``."""
    bm, bk, bn = tiles
    kind = instance_kind(dtype, m)
    if kind == "fma":
        return MB.STAGES
    if kind == "mma_t":
        stages = MMA_T_STAGES
        if bn not in MMA_T_COLS:
            raise ValueError(
                f"bn = {bn}: the transposed instance (M <= {MMA_T_ROWS}) "
                f"takes bn in {MMA_T_COLS}")
    else:
        stages = mma_stages(bm, bk, bn, 1 if int8 else None)
        if mma_layout(bm, bn) is None:
            raise ValueError(
                f"output tile ({bm}, {bn}): no warp grid of the "
                f"tensor-core instance holds it (at most {MAX_FRAGMENTS} "
                f"m16 x n8 fragments a warp, {MAX_M_TILES} down, "
                f"{MAX_N_TILES} across)")
    need = smem_bytes_required(bm, bk, bn, 2, 1 if int8 else None, m=m,
                               stages=stages)
    if need > optin_bytes:
        raise ValueError(f"tiles {tiles} need {need} bytes of shared "
                         f"memory per block; this card allows {optin_bytes}")
    return stages
