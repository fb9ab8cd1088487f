"""Epilogue-fused blocked GEMM: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.matmul_fused.matmul_fused`` (kernel row 9) for
wide weights: ``Y = act(A @ W * scale + bias) * mul + residual`` in one
kernel, so the output tile's pointwise tail never round-trips through
HBM.  The kernel lives in ``csrc/matmul_fused.cu`` (design and bound in
its header comment): the tile core of ``matmul_blocked``, with the
epilogue applied in fp32 to each output element after the last k step
and one cast at the end.  The epilogue operands are read into registers
at the store, not staged, so the shared-memory footprint is exactly
``matmul_blocked``'s and the ``"matmul_fused"`` schedule key ranks the
``"matmul"`` candidates.  Ragged edges are masked: every shape launches.

The int8-weight variant (JAX ``ops.matmul_fused`` with a
``QuantizedTensor``) comes with the quantized slice (``ROADMAP.md``,
queue 1, item 10).
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
                        bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one block: ``matmul_blocked``'s staged A
    and B tiles.  No epilogue operand is staged."""
    return MB.smem_bytes_required(bm, bk, bn, bytes_per_elem)


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
    ``(bm, bk, bn)``; any M, N, K.  ``scale`` (N,) or a scalar and
    ``bias`` (N,) are taken in fp32; ``mul`` and ``residual`` are (M, N)
    in ``a``'s dtype.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`matmul_fused_ref`.
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if a.device.type == "cpu":
        return matmul_fused_ref(a, w, scale, bias, mul, residual, act=act)
    MB._check(a, w, bm, bk, bn, name="matmul_fused")
    m, k = a.shape
    n = w.shape[1]
    rows = {}
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            t = torch.as_tensor(t, dtype=torch.float32, device=a.device)
            if t.numel() == 1:
                t = t.reshape(1).expand(n)
            if tuple(t.shape) != (n,):
                raise ValueError(f"{name} must be ({n},), got "
                                 f"{tuple(t.shape)}")
            rows[name] = t.contiguous()
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
    fn = _build.load("matmul_fused", "matmul_fused_fwd", _ARGTYPES)
    err = fn(MB._DTYPES[a.dtype], a.data_ptr(), w.data_ptr(),
             out.data_ptr(), ptr(rows.get("scale")), ptr(rows.get("bias")),
             ptr(mul), ptr(residual), _ACT_IDS[act], m, n, k, bm, bk, bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    return out


matmul_fused.launches = 0
