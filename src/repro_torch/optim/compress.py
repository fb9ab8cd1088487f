"""int8 gradient compression with error feedback (the port of
``repro.optim.compress``).

Each tensor is quantized to int8 with a per-tensor scale; the error
(what the int8 values could not carry) is the residual the caller may
add to the next step's gradients.  It is a pure (de)quantization round
trip.  On a mesh the train step does what JAX's does: it compresses the
already-reduced gradients (``models.spmd.compress_tree``: each tensor's
scale is its global max, so every shard is quantized as the unsharded
tensor would be).  Compressing before the reduction, so that the int8
values are what the all-reduce carries, is what JAX's docstring hopes
for and its code does not do; the port does not do it either.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import leaves, unflatten


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the fp32 scale ``max|g| / 127 + 1e-12``; rounding
    half to even, as ``jnp.round``."""
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, residual: Any | None = None,
                  groups: list | None = None, reduce_max=None
                  ) -> tuple[Any, Any]:
    """Quantize a gradient tree with error feedback.  Returns
    (quantized grads as fp32, new residual).

    Each tensor has its own scale, as in JAX, where a tensor may hold
    several of the port's leaves: ``groups`` (one id per leaf, in
    ``leaves`` order; ``transformer.jax_stacking`` gives JAX's stacked
    layers) makes the leaves of one id share one scale, from the max
    over all of them.  ``reduce_max(i, amax)`` returns leaf i's max over
    every rank that holds a shard of it (on a mesh,
    ``models.spmd.compress_tree``)."""
    gl = leaves(grads)
    rl = ([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
           for g in gl] if residual is None else leaves(residual))
    totals = [g.float() + r for g, r in zip(gl, rl)]
    amax = [torch.max(torch.abs(t)) for t in totals]
    if reduce_max is not None:
        amax = [reduce_max(i, a) for i, a in enumerate(amax)]
    ids = groups if groups is not None else list(range(len(gl)))
    top: dict = {}
    for i, a in zip(ids, amax):
        top[i] = a if i not in top else torch.maximum(top[i], a)
    deq, res = [], []
    for i, total in zip(ids, totals):
        scale = top[i] / 127.0 + 1e-12
        d = decompress(torch.clamp(torch.round(total / scale), -127,
                                   127).to(torch.int8), scale)
        deq.append(d)
        res.append(total - d)
    return unflatten(grads, deq), unflatten(grads, res)
