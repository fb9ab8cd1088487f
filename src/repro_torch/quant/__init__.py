"""Quantization (the port of ``repro.quant``).

:class:`QuantizedTensor` (int8 or fp8 payload, fp32 scale),
:func:`quantize` / :func:`fake_quant`, the parameter-tree helpers
:func:`quantize_params`, :func:`dequantize_params` and
:func:`quantized_bytes`, data-driven activation calibration
(:class:`AbsMaxCalibrator`) and the fake-quant accuracy harness
(:func:`logit_report`).  The kernels are ``kernels/matmul_q.py``
(``matmul_w8``), the int8 variant of ``kernels/matmul_fused.py`` and
``kernels/flash_decode.flash_decode_fp8``.
"""

from repro_torch.quant.calibrate import AbsMaxCalibrator
from repro_torch.quant.fakequant import logit_report, sequence_logits
from repro_torch.quant.params import (QUANT_KEYS, dequantize_params,
                                      quantize_params, quantized_bytes)
from repro_torch.quant.quantize import (FP8_MAX, INT8_MAX, QUANT_DTYPES,
                                        QuantizedTensor, fake_quant,
                                        quantize)

__all__ = [
    "AbsMaxCalibrator", "FP8_MAX", "INT8_MAX", "QUANT_DTYPES",
    "QUANT_KEYS", "QuantizedTensor", "dequantize_params", "fake_quant",
    "logit_report", "quantize", "quantize_params", "quantized_bytes",
    "sequence_logits",
]
