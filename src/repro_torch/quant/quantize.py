"""Quantized tensors: per-channel / per-tensor scales for int8 and fp8
(the port of ``repro.quant.quantize``).

A :class:`QuantizedTensor` is a narrow payload plus an fp32 scale.  The
rest of the port keys off the payload's itemsize: one byte per element
is what the ``"matmul_w8"`` kernel streams and what the schedule keys
price.

Scale conventions, as in JAX:

* ``reduce_axis=-2`` (default) -- per-output-channel weight scales: a
  projection ``W[K, N]`` reduces its absmax over the contraction dim K,
  leaving one fp32 scale per output channel ``(1, N)``;
* ``reduce_axis=None`` -- per-tensor: one scalar scale (shape all ones).

``sum_k a[m,k] * (q[k,n] * s[n]) == s[n] * sum_k a[m,k] * q[k,n]``: the
scale depends only on the output channel, so the kernels accumulate the
narrow payload in fp32 and apply the scale once, in the epilogue.

The arithmetic follows JAX's step for step in fp32 (``absmax / qmax +
eps``, then ``x / scale``, round half to even, clip), so the same fp32
input gives the same int8 bytes, fp8 bytes and scales.
"""

from __future__ import annotations

import dataclasses

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0        # float8_e4m3fn finfo.max
_EPS = 1e-12

QUANT_DTYPES = {
    "int8": (torch.int8, INT8_MAX),
    "fp8": (torch.float8_e4m3fn, FP8_MAX),
}


@dataclasses.dataclass
class QuantizedTensor:
    """A narrow payload and its fp32 dequantization scale."""

    q: torch.Tensor          # int8 or float8_e4m3fn
    scale: torch.Tensor      # fp32, broadcastable to q.shape

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))


def quantize(x: torch.Tensor, dtype: str = "int8",
             reduce_axis: int | None = -2) -> QuantizedTensor:
    """Absmax-quantize ``x`` to int8 or fp8 (e4m3).

    ``reduce_axis`` is the axis the absmax reduces over (the contraction
    dim for weights, giving per-output-channel scales); ``None`` reduces
    everything (a per-tensor scale).
    """
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"unknown quant dtype {dtype!r}; "
                         f"expected one of {sorted(QUANT_DTYPES)}")
    target, qmax = QUANT_DTYPES[dtype]
    xf = x.float()
    dims = tuple(range(x.dim())) if reduce_axis is None else (reduce_axis,)
    absmax = torch.amax(torch.abs(xf), dim=dims, keepdim=True)
    scale = absmax / qmax + _EPS
    if dtype == "int8":
        q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    else:
        q = xf / scale        # the e4m3 rounding happens in the cast below
    return QuantizedTensor(q.to(target), scale)


def fake_quant(x: torch.Tensor, dtype: str = "int8",
               reduce_axis: int | None = -2) -> torch.Tensor:
    """Quantize-dequantize round trip in ``x.dtype``: the reference
    semantics every quantized kernel must match."""
    return quantize(x, dtype, reduce_axis).dequant(x.dtype)
