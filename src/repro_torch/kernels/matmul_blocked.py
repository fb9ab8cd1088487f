"""Blocked GEMM: CUDA kernels, wrapper and plain version.

Port of ``repro.kernels.matmul_blocked.matmul_blocked`` (kernel row 6).
The kernels live in ``csrc/matmul_blocked.cu`` (design and bound in its
header comment; the ``"mma"`` instance in ``csrc/matmul_blocked_mma.cu``,
a library of its own so that the two build in parallel):
``C[M, N] = A[M, K] @ B[K, N]`` with row-major operands, an fp32 sum
held across the whole K loop, output in the input dtype, fp32 and bf16.
Three instances (``matmul_fused.instance_kind``):

* fp32, ``"fma"``: the CUDA-core tile core of ``csrc/gemm_tile.cuh``
  with no epilogue (TF32 would break the fp32 tolerances);
* bf16, ``"mma_t"`` (M <= 16) and ``"mma"`` (M > 16): row 9's
  tensor-core instances (``csrc/gemm_mma_inst.cuh``) over one weight
  matrix with a plain store (``BlockedMap``: the sum cast once).

The tiles ``(bm, bk, bn)`` come from the blocking model
(``core.hopper_adapter`` through ``tune.best_schedule``, the
``"matmul"`` key: in bf16 snapped to the instance that runs them, at
decode one tile whose column blocks fill the card) and are runtime
arguments.  Ragged M, N and K edges are masked inside the kernels, so
every shape launches: the JAX op's fallback to ``matmul_ref`` for tiles
that do not divide is not carried over.

The footprint functions here are the fp32 tile core's, which
``matmul_fused``, ``matmul_w8`` and ``qkv_fused`` also run in fp32; the
bf16 instances' are ``matmul_fused``'s.  The wrapper is forward only:
the differentiable product is ``ops.matmul``, whose backward runs the
dgrad kernels (``kernels/matmul_bwd.py``).  It records what ran in
``matmul_blocked.instance``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])

THREADS = 256             # threads per block (csrc: kThreads)
COLS_PER_THREAD = 4       # output columns a thread holds (csrc: kCols)
MAX_ROWS_PER_THREAD = 16  # output rows a thread holds (csrc: kMaxRows)
STAGES = 2                # tiles in flight: the current step and the next
INT8_COLS = 16            # int8 columns per 16-byte copy


def smem_bytes_required(bm: int, bk: int, bn: int,
                        bytes_per_elem: int = 2,
                        w_bytes: int | None = None) -> int:
    """Dynamic shared memory of one block: an A tile (bm, bk) in the
    input dtype and a B tile (bk, bn) at ``w_bytes`` per element (the
    input's width unless given: 1 for an int8 weight), two stages deep.
    The fp32 accumulator is in registers (:func:`accumulators_per_thread`),
    not here."""
    wb = bytes_per_elem if w_bytes is None else w_bytes
    return STAGES * (bm * bk * bytes_per_elem + bk * bn * wb)


def accumulators_per_thread(bm: int, bn: int) -> int:
    """fp32 accumulators each thread holds for a (bm, bn) output tile:
    the block's threads tile it as ``THREADS // ceil(bn / 4)`` thread-rows
    by ``ceil(bn / 4)`` column groups of 4.  Returns a number above the
    kernel's limit (``4 * MAX_ROWS_PER_THREAD``) when bn is too wide for
    one column group per thread."""
    groups = -(-bn // COLS_PER_THREAD)
    if groups > THREADS:
        return THREADS * COLS_PER_THREAD * bm
    thread_rows = THREADS // groups
    return COLS_PER_THREAD * -(-bm // thread_rows)


def hbm_bytes(M: int, N: int, K: int, bm: int, bk: int, bn: int,
              bytes_per_elem: int = 2) -> int:
    """Global-memory bytes the grid's loads and stores issue: every block
    of a grid column reads its A row-panel, so A is read ceil(N / bn)
    times and B ceil(M / bm) times; C is written once.  ``bk`` does not
    change the count (it is the staging step, not a reuse boundary).
    L2 may serve some of the repeated reads: this counts requests, not
    HBM transfers."""
    del bk
    gm, gn = -(-M // bm), -(-N // bn)
    return (M * K * gn + K * N * gm + M * N) * bytes_per_elem


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the fp32 product cast to the input dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_blocked(a: torch.Tensor, b: torch.Tensor, *, bm: int, bk: int,
                   bn: int) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` tiled ``(bm, bk, bn)``; any M, N, K.  The
    bf16 instances keep ``matmul_fused.mma_stages`` (``"mma"``) or
    ``MMA_T_STAGES`` (``"mma_t"``) reduction steps in flight.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_ref`.
    """
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    # matmul_fused imports this module (the tile core's footprint)
    from repro_torch.kernels import matmul_fused as MF
    _check(a, b, bm, bk, bn, core_tiles=a.dtype != torch.bfloat16)
    m, k = a.shape
    n = b.shape[1]
    stages = MF.check_tiles(a.dtype, m, (bm, bk, bn), False,
                            torch.cuda.get_device_properties(
                                a.device).shared_memory_per_block_optin)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = ("matmul_blocked_mma" if MF.instance_kind(a.dtype, m) == "mma"
           else "matmul_blocked")
    fn = _build.load(lib, f"{lib}_fwd", _ARGTYPES)
    err = fn(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
             m, n, k, bm, bk, bn, stages,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_blocked")
    matmul_blocked.launches += 1
    matmul_blocked.instance = MF.instance(a.dtype, m, bm, bn, stages)
    return out


matmul_blocked.launches = 0
matmul_blocked.instance = None   # ("mma" | "mma_t" | "fma", layout, stages)


def fp32_row(t, n: int, name: str, device: torch.device) -> torch.Tensor:
    """An epilogue row (a scale or a bias) as a contiguous fp32 (N,)
    tensor on ``device``: N values as they are ((N,) or (1, N)), one value
    broadcast."""
    r = torch.as_tensor(t, dtype=torch.float32, device=device)
    if r.numel() == 1:
        r = r.reshape(1).expand(n)
    if r.numel() != n:
        raise ValueError(f"{name} must hold 1 or {n} values, got "
                         f"{tuple(r.shape)}")
    return r.reshape(n).contiguous()


def _check(a, b, bm, bk, bn, name="matmul_blocked", n_cols=None,
           int8_b=False, core_tiles=True):
    """Raise on what the tile core does not take: ``a (M, K) @ b (K, N)``
    on one CUDA device in one dtype, contiguous, with tiles whose staged
    A and B tiles fit the card's shared memory and whose accumulator
    fits the register limit.  ``n_cols``: the tile's output width when it
    is not ``bn`` (the joint width of qkv_fused).  ``int8_b``: b is an
    int8 weight (the quantized kernels), staged at one byte per element,
    16 columns per 16-byte copy, so N and bn must be multiples of 16.
    ``core_tiles=False``: the operands only (a kernel off this tile core
    checks its own tiles)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name} runs on cuda or cpu; a is on "
                         f"{a.device}, b on {b.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            f"{name} is forward only: the differentiable blocked GEMM is "
            "ops.matmul (its backward runs the dgrad kernels); the fused "
            "and quantized GEMMs are inference-only, as in JAX")
    if int8_b:
        if a.dtype not in _DTYPES or b.dtype != torch.int8:
            raise TypeError(f"a must be one of {sorted(map(str, _DTYPES))} "
                            f"and the weight int8; got {a.dtype}, {b.dtype}")
    elif a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"a and b must share one of "
                        f"{sorted(map(str, _DTYPES))}; got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do "
                         "not make a matrix product")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (row-major)")
    if a.shape[0] == 0 or b.shape[1] == 0:
        raise ValueError("an empty output has nothing to launch")
    if min(bm, bk, bn) < 1:
        raise ValueError(f"tiles must be positive, got {(bm, bk, bn)}")
    if int8_b and (b.shape[1] % INT8_COLS or bn % INT8_COLS):
        raise ValueError(
            f"an int8 weight is staged {INT8_COLS} columns per 16-byte "
            f"copy: N = {b.shape[1]} and bn = {bn} must be multiples of "
            f"{INT8_COLS}")
    if not core_tiles:
        return
    cols = n_cols or bn
    acc = accumulators_per_thread(bm, cols)
    if acc > COLS_PER_THREAD * MAX_ROWS_PER_THREAD:
        raise ValueError(
            f"tiles (bm={bm}, bn={bn}) need {acc} fp32 accumulators per "
            f"thread; the kernel holds at most "
            f"{COLS_PER_THREAD * MAX_ROWS_PER_THREAD}")
    need = smem_bytes_required(bm, bk, cols, a.element_size(),
                               b.element_size())
    have = torch.cuda.get_device_properties(
        a.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(
            f"tiles {(bm, bk, bn)} need {need} bytes of shared memory per "
            f"block; this card allows {have}")
