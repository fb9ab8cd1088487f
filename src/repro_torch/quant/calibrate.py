"""Activation calibration: observed ranges -> quantization scales (the
port of ``repro.quant.calibrate``).

Weights are quantized from their own values (``quant.quantize``), but
activation scales (the ``a8`` half of w8a8) must come from *data* -- the
ranges a layer actually sees.  The calibrator accumulates per-leaf
statistics over observation batches and emits scales compatible with
:mod:`repro_torch.quant.quantize`.

Two estimators:

* ``absmax``     -- running max of |x| (exact range, outlier-sensitive);
* ``ema_absmax`` -- exponential moving average of the per-batch absmax
  (the standard PTQ smoothing for spiky activations; ``momentum``
  controls the horizon).

The statistics are fp32 0-d tensors on the device of the tensors they
summarise: observing a batch on the card reads nothing back to the host.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.base import map_tree
from repro_torch.quant.quantize import _EPS, QUANT_DTYPES


def _structure(tree: Any) -> Any:
    """A tree's shape without its leaves: dict keys and list lengths."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def _zip_map(fn, a: Any, b: Any) -> Any:
    """``fn`` over the paired leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _absmax(x: Any) -> torch.Tensor:
    return torch.as_tensor(x).detach().float().abs().amax()


class AbsMaxCalibrator:
    """Running per-leaf activation-range tracker.

    ``observe(tree)`` folds one batch of activations (a tree of dicts
    and lists over tensors) into the running statistics;
    ``scales(dtype)`` returns the matching tree of fp32 0-d scales.
    Leaves are matched by tree structure: observing a tree of another
    structure raises ``ValueError``.
    """

    def __init__(self, momentum: float | None = None):
        if momentum is not None and not 0.0 < momentum < 1.0:
            raise ValueError(f"momentum must be in (0, 1), got {momentum}")
        self.momentum = momentum
        self._absmax: Any = None
        self._structure: Any = None
        self.n_batches = 0

    def observe(self, tree: Any) -> None:
        structure = _structure(tree)
        if self._absmax is not None and structure != self._structure:
            raise ValueError(
                f"observed a tree of structure {structure}, expected "
                f"{self._structure}")
        batch_max = map_tree(_absmax, tree)
        if self._absmax is None:
            self._absmax, self._structure = batch_max, structure
        elif self.momentum is None:
            self._absmax = _zip_map(torch.maximum, self._absmax, batch_max)
        else:
            m = self.momentum
            self._absmax = _zip_map(
                lambda old, new: m * old + (1.0 - m) * new,
                self._absmax, batch_max)
        self.n_batches += 1

    def scales(self, dtype: str = "int8") -> Any:
        """Per-leaf fp32 scales such that observed values quantize into
        the target dtype's representable range."""
        if self._absmax is None:
            raise ValueError("no batches observed yet")
        if dtype not in QUANT_DTYPES:
            raise ValueError(f"unknown quant dtype {dtype!r}; "
                             f"expected one of {sorted(QUANT_DTYPES)}")
        _, qmax = QUANT_DTYPES[dtype]
        return map_tree(lambda a: a / qmax + _EPS, self._absmax)
