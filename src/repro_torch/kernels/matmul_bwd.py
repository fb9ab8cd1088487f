"""Backward (dgrad) GEMMs of the blocked GEMM: CUDA kernels, wrappers and
plain versions.

Port of ``repro.kernels.matmul_bwd`` (kernel rows 7 and 8).  For
``C[M, N] = A[M, K] @ B[K, N]``:

* :func:`matmul_dgrad_a`: ``dA[M, K] = g[M, N] @ B[K, N]^T`` (NT);
* :func:`matmul_dgrad_b`: ``dB[K, N] = A[M, K]^T @ g[M, N]`` (TN).

The kernels live in ``csrc/matmul_bwd.cu`` (design and bound in its
header comment): the transposed operand is read transposed on the tile,
never materialised in HBM, and each block holds its fp32 sums across the
whole reduction (for dB all of M), so repeated launches agree bit for
bit.  Tiles follow the ``"matmul_dgrad"`` key's (M_out, K_reduce, N_out)
roles, as in JAX: dA asks the key for dims ``(M, K, N)`` and takes
``(bm, br, bo)``, dB asks ``(K, N, M)`` and takes ``(bk, br, bn)``.
Ragged edges are masked inside the kernels, so every shape launches
(JAX's ops take ``jnp.dot`` for tiles that do not divide).  Output in the
input dtype.  Two instances: bf16 multiplies on the tensor cores
(``mma.sync`` over swizzled tiles, ``csrc/gemm_mma.cuh``; the warp grid
is :func:`mma_layout`), fp32 on the CUDA cores (TF32 would break the fp32
tolerances); each wrapper records the instance it launched in its
``instance`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hopper_adapter import default_smem_budget
from repro_torch.kernels import _build
from repro_torch.kernels.matmul_blocked import (COLS_PER_THREAD,
                                                MAX_ROWS_PER_THREAD, STAGES)
from repro_torch.kernels.matmul_blocked import \
    accumulators_per_thread as fma_accumulators

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])

# bf16, the tensor cores (mma.sync m16n8k16; csrc/gemm_mma.cuh)
THREADS = 256
WARPS = THREADS // 32
MMA_M, MMA_N = 16, 8      # one fragment: 16 rows x 8 columns
K_STEP = 16               # reduction depth of one mma
CHUNK = 8                 # bf16 elements in one 16-byte chunk
MAX_FRAGMENTS = 16        # fragments a warp holds: 64 fp32 sums a thread
MAX_M_TILES = 8           # m16 fragments a warp holds
MAX_N_TILES = 8           # n8 fragments a warp holds (a power of two)
MMA_STAGES = (2, 3)       # reduction steps in flight the instance runs


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mma_layout(rows: int, cols: int) -> tuple[int, int, int, int] | None:
    """The bf16 kernels' warp grid for a ``rows`` x ``cols`` output tile:
    ``(wm, wn, mt, nt)``, ``wn`` warps across the columns and ``wm = 8 //
    wn`` down the rows, each holding ``mt`` m16 x ``nt`` n8 fragments,
    ``nt`` a power of two (a B ``ldmatrix.x4`` loads a pair of n8 tiles),
    ``mt <= 8``, ``nt <= 8``, ``mt * nt <= 16``.  Of those: the fewest
    computed rows (``16 wm mt``: no m16 rows left empty where a grid
    allows it), then the fewest computed elements, then the fewest
    fragment loads a k16 step (``mt + ceil(nt / 2)``), then the fewest
    warps across.  None where no grid holds the tile.  csrc:
    ``gemm_mma::mma_layout``."""
    mt_all, nt_all = _ceil(rows, MMA_M), _ceil(cols, MMA_N)
    best, best_key = None, None
    for wn in (1, 2, 4, 8):
        wm = WARPS // wn
        mt = _ceil(mt_all, wm)
        nt = 1
        while nt < _ceil(nt_all, wn):
            nt *= 2
        if mt > MAX_M_TILES or nt > MAX_N_TILES or mt * nt > MAX_FRAGMENTS:
            continue
        key = (MMA_M * wm * mt, MMA_M * wm * mt * MMA_N * wn * nt,
               mt + _ceil(nt, 2))
        if best_key is None or key < best_key:
            best, best_key = (wm, wn, mt, nt), key
    return best


def empty_row_share(rows: int, cols: int) -> float:
    """Share of the bf16 kernels' computed rows (``16 wm mt``) that lie
    past the tile's ``rows``: computed and never stored (1 where no grid
    holds the tile)."""
    layout = mma_layout(rows, cols)
    if layout is None:
        return 1.0
    wm, _, mt, _ = layout
    return 1 - rows / (MMA_M * wm * mt)


def staged_chunks(w: int) -> tuple[int, int, int]:
    """How the bf16 kernels stage a row of ``w`` 16-byte chunks: ``(ld,
    shift, mask)``, chunk ``c`` of row ``r`` at chunk ``r * ld + (c ^ ((r
    >> shift) & mask))``.  A power of two ``w >= 8`` is XOR-swizzled by
    ``r & 7``, ``w = 4`` and ``2`` by the row's 128-byte line, an odd
    ``w`` is left as it is, any other ``w`` padded by one chunk to odd,
    so the 8 rows of one ``ldmatrix`` sub-matrix fall into 8 bank groups
    (csrc: ``gemm_mma::Tile``)."""
    pow2 = w & (w - 1) == 0
    ld = w if w % 2 or pow2 else w + 1
    if not pow2 or w < 2:
        return ld, 0, 0
    lw = w.bit_length() - 1
    return ld, max(0, 3 - lw), min(w, 8) - 1


def chunk_at(w: int, r: int, c: int) -> int:
    """Chunk index of chunk ``c`` of staged row ``r`` in a tile of rows of
    ``w`` chunks (:func:`staged_chunks`)."""
    ld, shift, mask = staged_chunks(w)
    return r * ld + (c ^ ((r >> shift) & mask))


def instance_kind(dtype: torch.dtype) -> str:
    """The instance a CUDA tensor of ``dtype`` launches: ``"mma"`` (bf16,
    tensor cores) or ``"fma"`` (fp32, CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def accumulators_per_thread(rows: int, cols: int, itemsize: int = 2) -> int:
    """fp32 sums each thread holds for a ``rows`` x ``cols`` output tile:
    bf16, four per fragment of :func:`mma_layout` (above the limit where
    no grid holds the tile); fp32, the CUDA-core layout of the forward
    GEMM (``matmul_blocked.accumulators_per_thread``)."""
    if itemsize != 2:
        return fma_accumulators(rows, cols)
    layout = mma_layout(rows, cols)
    if layout is None:
        return 4 * _ceil(rows, MMA_M) * _ceil(cols, MMA_N)
    return 4 * layout[2] * layout[3]


def _mma_chunks(bm: int, bk: int, bn: int, kernel: str) -> int:
    """16-byte chunks of one stage of the bf16 ``kernel``: NT stages ``bm
    + bn`` rows of the step's chunks, TN the step's rows of ``ceil(bm /
    8)`` and ``ceil(bn / 8)`` chunks, each row as :func:`staged_chunks`
    lays it out; the step rounded up to whole k16 steps."""
    bkp = _ceil(bk, K_STEP) * K_STEP
    if kernel == "nt":
        return (bm + bn) * staged_chunks(bkp // CHUNK)[0]
    return bkp * (staged_chunks(_ceil(bm, CHUNK))[0]
                  + staged_chunks(_ceil(bn, CHUNK))[0])


def mma_stages(bm: int, bk: int, bn: int) -> int:
    """The bf16 instance's reduction steps in flight at these tiles:
    three where both kernels' three stages fit the two-block budget
    (115,712 B; three ran a little faster than two at the model's tile),
    else two."""
    worst = max(_mma_chunks(bm, bk, bn, k) for k in ("nt", "tn"))
    return 3 if 3 * worst * 16 <= default_smem_budget() else 2


def smem_bytes_required(bm: int, bk: int, bn: int, bytes_per_elem: int = 2,
                        kernel: str | None = None,
                        stages: int | None = None) -> int:
    """Dynamic shared memory of one block of the dgrad kernel ``kernel``
    (``"nt"``, dA; ``"tn"``, dB; None: the larger of the two) for an (bm,
    bn) output tile and a reduction step of bk.

    bf16 (the tensor cores): ``stages`` buffers (default
    :func:`mma_stages`, the instance that runs) of both staged tiles
    (:func:`_mma_chunks`).  fp32 (the CUDA cores): two stages of a ``(bm
    + bn) x bk`` operand pair, the step rounded up to 8 elements (the NT
    kernel's whole 16-byte chunks), the forward GEMM's footprint whenever
    bk is a multiple of 8."""
    if bytes_per_elem != 2:
        return STAGES * (bm + bn) * _ceil(bk, 8) * 8 * bytes_per_elem
    stages = stages or mma_stages(bm, bk, bn)
    kernels = ("nt", "tn") if kernel is None else (kernel,)
    return stages * max(_mma_chunks(bm, bk, bn, k) for k in kernels) * 16


def matmul_dgrad_a_ref(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of dA = g @ b.T: the fp32 product cast to g's
    dtype."""
    return (g.float() @ b.float().T).to(g.dtype)


def matmul_dgrad_b_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of dB = a.T @ g: the fp32 product cast to a's
    dtype."""
    return (a.float().T @ g.float()).to(a.dtype)


def matmul_dgrad_a(g: torch.Tensor, b: torch.Tensor, *, bm: int, br: int,
                   bo: int, stages: int | None = None) -> torch.Tensor:
    """``dA[M, K] = g[M, N] @ b[K, N]^T``, tiled bm rows of M, br of the
    reduction N, bo columns of K; any M, N, K.  ``stages``: the bf16
    instance's reduction steps in flight (2 or 3; default
    :func:`mma_stages`).

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_dgrad_a_ref`."""
    if g.device.type == "cpu":
        return matmul_dgrad_a_ref(g, b)
    stages = _check("matmul_dgrad_a", g, b, bm, br, bo, stages)
    m, n = g.shape
    k = b.shape[0]
    out = torch.empty((m, k), dtype=g.dtype, device=g.device)
    fn = _build.load("matmul_bwd", "matmul_dgrad_a", _ARGTYPES)
    err = fn(_DTYPES[g.dtype], g.data_ptr(), b.data_ptr(), out.data_ptr(),
             m, n, k, bm, br, bo, stages,
             torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "matmul_dgrad_a")
    matmul_dgrad_a.launches += 1
    matmul_dgrad_a.instance = _instance(g.dtype, bm, bo, stages)
    return out


matmul_dgrad_a.launches = 0
matmul_dgrad_a.instance = None   # ("mma", layout, stages) or ("fma", ...)


def matmul_dgrad_b(a: torch.Tensor, g: torch.Tensor, *, bk: int, br: int,
                   bn: int, stages: int | None = None) -> torch.Tensor:
    """``dB[K, N] = a[M, K]^T @ g[M, N]``, tiled bk rows of K, br of the
    reduction M, bn columns of N; any M, N, K.  ``stages`` as for
    :func:`matmul_dgrad_a`.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_dgrad_b_ref`."""
    if a.device.type == "cpu":
        return matmul_dgrad_b_ref(a, g)
    stages = _check("matmul_dgrad_b", a, g, bk, br, bn, stages)
    m, k = a.shape
    n = g.shape[1]
    out = torch.empty((k, n), dtype=a.dtype, device=a.device)
    fn = _build.load("matmul_bwd", "matmul_dgrad_b", _ARGTYPES)
    err = fn(_DTYPES[a.dtype], a.data_ptr(), g.data_ptr(), out.data_ptr(),
             m, n, k, bk, br, bn, stages,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_dgrad_b")
    matmul_dgrad_b.launches += 1
    matmul_dgrad_b.instance = _instance(a.dtype, bk, bn, stages)
    return out


matmul_dgrad_b.launches = 0
matmul_dgrad_b.instance = None


def _instance(dtype, rows, cols, stages):
    """What a launch ran: ``("mma", (wm, wn, mt, nt), stages)`` in bf16,
    ``("fma", rows a thread holds, stages)`` in fp32."""
    if instance_kind(dtype) == "mma":
        return "mma", mma_layout(rows, cols), stages
    return "fma", fma_accumulators(rows, cols) // COLS_PER_THREAD, stages


def _check(name, x, y, t_rows, t_red, t_cols, stages):
    """Raise on what the dgrad kernels do not take (the operands, then
    :func:`check_tiles` against this card's shared memory); returns the
    stage count to launch."""
    _check_operands(name, x, y)
    optin = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    kernel = "nt" if name == "matmul_dgrad_a" else "tn"
    return check_tiles(kernel, x.dtype, (t_rows, t_red, t_cols), stages,
                       optin)


def _check_operands(name, x, y):
    """Two contiguous 2-D operands on one CUDA device in one dtype whose
    shapes make the product (dA: g (M, N), b (K, N); dB: a (M, K), g (M,
    N): the first dims agree)."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name} runs on cuda or cpu; operands are on "
                         f"{x.device} and {y.device}")
    if x.dtype != y.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name}: operands must share one of "
                        f"{sorted(map(str, _DTYPES))}; got {x.dtype}, "
                        f"{y.dtype}")
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"{name}: operands must be 2-D")
    agree = (x.shape[1] == y.shape[1] if name == "matmul_dgrad_a"
             else x.shape[0] == y.shape[0])
    if not agree:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} do not make the product")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous (row-major)")
    if x.numel() == 0 or y.numel() == 0:
        raise ValueError(f"{name}: an empty operand has nothing to launch")


def check_tiles(kernel: str, dtype: torch.dtype,
                tiles: tuple[int, int, int], stages: int | None,
                optin_bytes: int) -> int:
    """The stage count the instance of ``dtype`` launches ``kernel``
    (``"nt"``: dA, ``"tn"``: dB) with at ``tiles`` (rows, reduction step,
    columns), or raise where it does not hold them: bf16 (the tensor
    cores), 2 or 3 stages (default :func:`mma_stages`) and a warp grid of
    :func:`mma_layout`; fp32 (the CUDA cores), its two stages and its
    accumulator limit; either, its staged tiles within ``optin_bytes`` of
    shared memory."""
    t_rows, t_red, t_cols = tiles
    if min(tiles) < 1:
        raise ValueError(f"tiles must be positive, got {tiles}")
    if dtype == torch.bfloat16:
        stages = stages or mma_stages(*tiles)
        if stages not in MMA_STAGES:
            raise ValueError(f"the tensor-core instance runs 2 or 3 "
                             f"stages, not {stages}")
        if mma_layout(t_rows, t_cols) is None:
            raise ValueError(
                f"output tile ({t_rows}, {t_cols}): no warp grid of the "
                f"tensor-core instance holds it (at most {MAX_FRAGMENTS} "
                f"m16 x n8 fragments a warp, {MAX_M_TILES} down, "
                f"{MAX_N_TILES} across)")
    elif stages not in (None, STAGES):
        raise ValueError(f"the fp32 instance runs {STAGES} stages, not "
                         f"{stages}")
    else:
        stages = STAGES
        acc = fma_accumulators(t_rows, t_cols)
        if acc > COLS_PER_THREAD * MAX_ROWS_PER_THREAD:
            raise ValueError(
                f"output tile ({t_rows}, {t_cols}) needs {acc} fp32 "
                f"accumulators per thread; the kernel holds at most "
                f"{COLS_PER_THREAD * MAX_ROWS_PER_THREAD}")
    need = smem_bytes_required(t_rows, t_red, t_cols, dtype.itemsize,
                               kernel, stages)
    if need > optin_bytes:
        raise ValueError(f"tiles {tiles} need {need} bytes of shared "
                         f"memory per block; this card allows {optin_bytes}")
    return stages
