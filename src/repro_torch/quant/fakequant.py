"""Fake-quant accuracy harness: quantized model vs its wide reference
(the port of ``repro.quant.fakequant``).

The contract the quantized path is held to has two layers:

1. *kernel == fake-quant oracle* -- the int8/fp8 kernels reproduce the
   dequant-then-compute reference (``tests/test_torch_quant.py``, and
   on the card ``chip_smoke.py``);
2. *quantized model ~= wide model* -- running the transformer with
   :class:`QuantizedTensor` weights must track the original logits
   within the error the quantization itself introduces.  This module
   measures that: logit-level error and top-1 agreement over sample
   prompts.

Both trees run where their parameters are: on the card a quantized
tree's 2-D int8 projections go through ``ops.linear`` to the
``matmul_w8`` kernel and attention through ``flash_attention``;
``use_kernel=False`` takes every kernel's plain version instead.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _device(params: Any) -> torch.device:
    return params["embed"]["embedding"].device


def sequence_logits(cfg: Any, params: Any, tokens: Any,
                    use_kernel: bool = True) -> torch.Tensor:
    """fp32 logits ``(B, S, cfg.vocab)`` of the full-sequence forward of
    ``tokens`` ((B, S) ints) under ``params``, on their device."""
    # the model imports the kernels, which import this package
    from repro_torch.models import transformer as T
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, np.int32))
    toks = tokens.to(_device(params), torch.int32)
    with torch.inference_mode():
        h, _ = T.forward(cfg, params, toks, use_kernel=use_kernel)
        return T.logits_fn(cfg, params, h).float()[..., :cfg.vocab]


def logit_report(cfg: Any, params: Any, qparams: Any, tokens: Any,
                 use_kernel: bool = True) -> dict:
    """Compare full-sequence logits of ``params`` vs ``qparams``.

    ``tokens``: (B, S) int prompts.  Returns max/mean absolute logit
    error, the largest normalized by the wide logits' scale, and
    per-position top-1 agreement -- the numbers a deployment gate would
    threshold -- as Python floats.  Both trees must sit on one device;
    the comparison runs there."""
    if _device(params) != _device(qparams):
        raise ValueError(f"params are on {_device(params)}, qparams on "
                         f"{_device(qparams)}: put both on one device")
    ref = sequence_logits(cfg, params, tokens, use_kernel)
    got = sequence_logits(cfg, qparams, tokens, use_kernel)
    err = (got - ref).abs()
    max_err = float(err.max())
    denom = max(float(ref.abs().max()), 1e-9)
    agree = (got.argmax(-1) == ref.argmax(-1)).double().mean()
    return {
        "max_abs_err": max_err,
        "mean_abs_err": float(err.double().mean()),
        "rel_err": max_err / denom,
        "top1_agreement": float(agree),
    }
