"""Backward (dgrad) GEMMs of the blocked GEMM: CUDA kernels, wrappers and
plain versions.

Port of ``repro.kernels.matmul_bwd`` (kernel rows 7 and 8).  For
``C[M, N] = A[M, K] @ B[K, N]``:

* :func:`matmul_dgrad_a`: ``dA[M, K] = g[M, N] @ B[K, N]^T`` (NT);
* :func:`matmul_dgrad_b`: ``dB[K, N] = A[M, K]^T @ g[M, N]`` (TN).

The kernels live in ``csrc/matmul_bwd.cu`` (design and bound in its
header comment): the transposed operand is read transposed on the tile,
never materialised in HBM, and each block holds its fp32 accumulator
across the whole reduction (for dB all of M), so repeated launches agree
bit for bit.  Tiles follow the ``"matmul_dgrad"`` key's (M_out, K_reduce,
N_out) roles, as in JAX: dA asks the key for dims ``(M, K, N)`` and
takes ``(bm, br, bo)``, dB asks ``(K, N, M)`` and takes ``(bk, br, bn)``.
Ragged edges are masked inside the kernels, so every shape launches
(JAX's ops take ``jnp.dot`` for tiles that do not divide).  Output in the
input dtype, fp32 and bf16.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_blocked import (COLS_PER_THREAD,
                                                MAX_ROWS_PER_THREAD, STAGES,
                                                accumulators_per_thread)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def smem_bytes_required(bm: int, bk: int, bn: int,
                        bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one block of either dgrad kernel for an
    (bm, bn) output tile and a reduction step of bk: two stages of a
    (bm + bn) x bk operand pair, the step rounded up to 8 elements (the
    NT kernel's whole 16-byte chunks).  Equal to the forward GEMM's
    footprint whenever bk is a multiple of 8."""
    return STAGES * (bm + bn) * (-(-bk // 8) * 8) * bytes_per_elem


def matmul_dgrad_a_ref(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of dA = g @ b.T: the fp32 product cast to g's
    dtype."""
    return (g.float() @ b.float().T).to(g.dtype)


def matmul_dgrad_b_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of dB = a.T @ g: the fp32 product cast to a's
    dtype."""
    return (a.float().T @ g.float()).to(a.dtype)


def matmul_dgrad_a(g: torch.Tensor, b: torch.Tensor, *, bm: int, br: int,
                   bo: int) -> torch.Tensor:
    """``dA[M, K] = g[M, N] @ b[K, N]^T``, tiled bm rows of M, br of the
    reduction N, bo columns of K; any M, N, K.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_dgrad_a_ref`."""
    if g.device.type == "cpu":
        return matmul_dgrad_a_ref(g, b)
    _check("matmul_dgrad_a", g, b, bm, br, bo)
    m, n = g.shape
    k = b.shape[0]
    out = torch.empty((m, k), dtype=g.dtype, device=g.device)
    fn = _build.load("matmul_bwd", "matmul_dgrad_a", _ARGTYPES)
    err = fn(_DTYPES[g.dtype], g.data_ptr(), b.data_ptr(), out.data_ptr(),
             m, n, k, bm, br, bo,
             torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "matmul_dgrad_a")
    matmul_dgrad_a.launches += 1
    return out


matmul_dgrad_a.launches = 0


def matmul_dgrad_b(a: torch.Tensor, g: torch.Tensor, *, bk: int, br: int,
                   bn: int) -> torch.Tensor:
    """``dB[K, N] = a[M, K]^T @ g[M, N]``, tiled bk rows of K, br of the
    reduction M, bn columns of N; any M, N, K.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_dgrad_b_ref`."""
    if a.device.type == "cpu":
        return matmul_dgrad_b_ref(a, g)
    _check("matmul_dgrad_b", a, g, bk, br, bn)
    m, k = a.shape
    n = g.shape[1]
    out = torch.empty((k, n), dtype=a.dtype, device=a.device)
    fn = _build.load("matmul_bwd", "matmul_dgrad_b", _ARGTYPES)
    err = fn(_DTYPES[a.dtype], a.data_ptr(), g.data_ptr(), out.data_ptr(),
             m, n, k, bk, br, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_dgrad_b")
    matmul_dgrad_b.launches += 1
    return out


matmul_dgrad_b.launches = 0


def _check(name, x, y, t_rows, t_red, t_cols):
    """Raise on what the dgrad kernels do not take: two contiguous 2-D
    operands on one CUDA device in one dtype whose shapes make the
    product (dA: g (M, N), b (K, N); dB: a (M, K), g (M, N): the first
    dims agree), and tiles whose staged operands fit the card's shared
    memory and whose accumulator fits the register limit."""
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
    if min(t_rows, t_red, t_cols) < 1:
        raise ValueError(f"tiles must be positive, got "
                         f"{(t_rows, t_red, t_cols)}")
    acc = accumulators_per_thread(t_rows, t_cols)
    if acc > COLS_PER_THREAD * MAX_ROWS_PER_THREAD:
        raise ValueError(
            f"output tile ({t_rows}, {t_cols}) needs {acc} fp32 "
            f"accumulators per thread; the kernel holds at most "
            f"{COLS_PER_THREAD * MAX_ROWS_PER_THREAD}")
    need = smem_bytes_required(t_rows, t_red, t_cols, x.element_size())
    have = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"tiles {(t_rows, t_red, t_cols)} need {need} "
                         f"bytes of shared memory per block; this card "
                         f"allows {have}")
