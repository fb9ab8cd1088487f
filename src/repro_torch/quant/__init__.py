"""Quantization for the port's serving path (the port of
``repro.quant``'s ``quantize`` and ``params``).

:class:`QuantizedTensor` (int8 or fp8 payload, fp32 scale),
:func:`quantize` / :func:`fake_quant`, and the parameter-tree helpers
:func:`quantize_params`, :func:`dequantize_params` and
:func:`quantized_bytes`.  The kernels are ``kernels/matmul_q.py``
(``matmul_w8``), the int8 variant of ``kernels/matmul_fused.py`` and
``kernels/flash_decode.flash_decode_fp8``.  JAX's ``calibrate`` and
``fakequant`` are off the serving path and not ported yet
(``ROADMAP.md``, queue 1, item 10).
"""

from repro_torch.quant.params import (QUANT_KEYS, dequantize_params,
                                      quantize_params, quantized_bytes)
from repro_torch.quant.quantize import (FP8_MAX, INT8_MAX, QUANT_DTYPES,
                                        QuantizedTensor, fake_quant,
                                        quantize)

__all__ = [
    "FP8_MAX", "INT8_MAX", "QUANT_DTYPES", "QUANT_KEYS", "QuantizedTensor",
    "dequantize_params", "fake_quant", "quantize", "quantize_params",
    "quantized_bytes",
]
