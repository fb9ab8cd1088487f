"""Epilogue-fused blocked GEMM: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.matmul_fused.matmul_fused`` (kernel row 9), for
wide and int8 weights: ``Y = act(A @ W * scale + bias) * mul +
residual`` in one kernel, so the output tile's pointwise tail never
round-trips through HBM.  The kernel lives in ``csrc/matmul_fused.cu``
(design and bound in its header comment): the tile core of
``matmul_blocked``, with the epilogue applied in fp32 to each output
element after the last k step and one cast at the end.  The epilogue
operands are read into registers at the store, not staged, so the
shared-memory footprint is exactly ``matmul_blocked``'s and the
``"matmul_fused"`` schedule key ranks the ``"matmul"`` candidates.  Ragged edges are masked: every shape launches.

An int8 ``W`` (JAX ``ops.matmul_fused`` with a ``QuantizedTensor``; its
dequantisation scale in ``scale``) runs the same kernel with the weight
tile staged at one byte per element (``matmul_fused_w8_fwd``), so its
footprint is ``matmul_w8``'s and its tiles come from the ``"matmul_w8"``
key with no re-check (JAX re-checks a cached w8 tile against the fused
kernel's larger VMEM footprint; here the two footprints are one).  N and
bn must then be multiples of 16.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import matmul_blocked as MB

ACTIVATIONS = {
    "none": lambda y: y,
    "relu": torch.relu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),   # jax.nn.gelu
    "silu": F.silu,
}
_ACT_IDS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}   # csrc: enum Act
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def smem_bytes_required(bm: int, bk: int, bn: int,
                        bytes_per_elem: int = 2,
                        w_bytes: int | None = None) -> int:
    """Dynamic shared memory of one block: ``matmul_blocked``'s staged A
    and B tiles (B at ``w_bytes``: 1 for an int8 weight).  No epilogue
    operand is staged."""
    return MB.smem_bytes_required(bm, bk, bn, bytes_per_elem, w_bytes)


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
    dtype.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_fused_ref`.
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if a.device.type == "cpu":
        return matmul_fused_ref(a, w, scale, bias, mul, residual, act=act)
    int8 = w.dtype == torch.int8
    MB._check(a, w, bm, bk, bn, name="matmul_fused", int8_b=int8)
    m, k = a.shape
    n = w.shape[1]
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
    fn = _build.load("matmul_fused",
                     "matmul_fused_w8_fwd" if int8 else "matmul_fused_fwd",
                     _ARGTYPES)
    err = fn(MB._DTYPES[a.dtype], a.data_ptr(), w.data_ptr(),
             out.data_ptr(), ptr(rows.get("scale")), ptr(rows.get("bias")),
             ptr(mul), ptr(residual), _ACT_IDS[act], m, n, k, bm, bk, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    return out


matmul_fused.launches = 0
