"""int8 gradient compression with error feedback (the port of
``repro.optim.compress``).

Each tensor is quantized to int8 with a per-tensor scale; the error
(what the int8 values could not carry) is the residual the caller may
add to the next step's gradients.  Across a mesh the compressed values
would be what the gradient all-reduce carries; distribution is not
ported yet (``ROADMAP.md``, queue 1, item 16), so here, as off-mesh in
JAX, it is a pure (de)quantization round trip.
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


def compress_tree(grads: Any, residual: Any | None = None
                  ) -> tuple[Any, Any]:
    """Quantize a gradient tree with error feedback.  Returns
    (quantized grads as fp32, new residual)."""
    gl = leaves(grads)
    rl = ([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
           for g in gl] if residual is None else leaves(residual))
    deq, res = [], []
    for g, r in zip(gl, rl):
        total = g.float() + r
        d = decompress(*compress(total))
        deq.append(d)
        res.append(total - d)
    return unflatten(grads, deq), unflatten(grads, res)
