"""Quantized-parameter containers for the port's parameter tree (the
port of ``repro.quant.params``).

``quantize_params`` walks a built tree (``transformer.init_params``, or
``convert.params_from_numpy``; one entry per layer) and replaces the
dense projection weights with :class:`QuantizedTensor` leaves: int8
payload and per-output-channel fp32 scales, ``(1, N)`` for each layer's
``(K, N)`` weight.  The matmul sites dispatch through
``kernels.ops.linear`` / ``ops.matmul_fused``, which send 2-D int8
weights to the ``matmul_w8`` kernel (or its plain version on the CPU).

What gets quantized: the attention projections (wq/wk/wv/wo) and the
dense MLP mats (w_up/w_down/w_gate).  What stays wide: norms and other
1-D leaves, embeddings and the lm head, and -- JAX's rules, kept though
granite has neither -- MoE expert banks (a node with a ``router`` leaf)
and ``cross`` (encoder-decoder cross-attention) nodes.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.quantize import QuantizedTensor, quantize

QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo",
                        "w_up", "w_down", "w_gate"})


def _quantizable(key: str, leaf: Any, keys: frozenset[str]) -> bool:
    return (key in keys and isinstance(leaf, torch.Tensor)
            and leaf.dim() >= 2 and leaf.is_floating_point())


def quantize_params(params: Any, dtype: str = "int8",
                    keys: frozenset[str] = QUANT_KEYS) -> Any:
    """Replace projection-weight leaves with QuantizedTensor containers
    (per-output-channel scales: absmax over the contraction dim)."""
    def rec(node: Any) -> Any:
        if isinstance(node, dict):
            if "router" in node:          # MoE expert bank: keep wide
                return node
            return {k: (node[k] if k == "cross"
                        else quantize(v, dtype, reduce_axis=-2)
                        if _quantizable(k, v, keys) else rec(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        if isinstance(node, tuple):
            return tuple(rec(v) for v in node)
        return node

    return rec(params)


def _walk(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    return fn(tree)


def dequantize_params(params: Any,
                      dtype: torch.dtype | None = None) -> Any:
    """Widen every QuantizedTensor leaf back to a dense tensor: the
    fake-quant reference tree."""
    def widen(leaf: Any) -> Any:
        if isinstance(leaf, QuantizedTensor):
            return leaf.dequant(dtype or torch.float32)
        return leaf
    return _walk(params, widen)


def quantized_bytes(params: Any) -> tuple[int, int]:
    """(container_bytes, bf16_dense_bytes) over the QuantizedTensor
    leaves only: the payload plus fp32 scales, against the same
    projections at bf16.  Unquantized leaves count in neither total."""
    totals = [0, 0]

    def count(leaf: Any) -> Any:
        if isinstance(leaf, QuantizedTensor):
            totals[0] += (leaf.q.numel() * leaf.q.element_size()
                          + leaf.scale.numel() * 4)
            totals[1] += leaf.q.numel() * 2
        return leaf
    _walk(params, count)
    return totals[0], totals[1]
