"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule (the port of ``repro.optim.adamw``), as plain
functions over the port's parameter trees (nested dicts and lists of
tensors).

JAX's rules hold exactly: the clip scale is ``min(1, clip_norm /
(gnorm + 1e-9))``, the schedule is computed in fp32, weight decay
applies to every leaf, the moments ``mu``/``nu`` are fp32, and each
update is computed in fp32 and cast back to the parameter's dtype.
``step`` is an int32 tensor on the parameters' device, so a step makes
no host round trip.  ``torch.optim.AdamW`` is not used: its clip,
schedule and decay differ.  Updates are functional (new tensors), as in
JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.base import map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree: Any) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order (dict
    insertion order, list order)."""
    out: list = []
    map_tree(out.append, tree)
    return out


def unflatten(tree: Any, values: list) -> Any:
    """``tree``'s structure with its leaves replaced by ``values`` (in
    :func:`leaves` order)."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (fp32): linear warmup, then cosine decay
    to ``min_lr_frac * lr``."""
    step = step.to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    t = (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def init_state(params: Any) -> dict:
    """fp32 zero moments shaped like the parameters, and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(c: AdamWConfig, params: Any, grads: Any,
                  state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(c, step)
    b1c = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                     device=step.device), step.float())
    b2c = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                     device=step.device), step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = c.b1 * mu + (1 - c.b1) * g
        nu = c.b2 * nu + (1 - c.b2) * g * g
        muh = mu / b1c
        nuh = nu / b2c
        delta = muh / (torch.sqrt(nuh) + c.eps) + c.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    new = [upd(p, g, m, n) for p, g, m, n in
           zip(leaves(params), leaves(grads), leaves(state["mu"]),
               leaves(state["nu"]))]
    new_params = unflatten(params, [x[0] for x in new])
    new_state = {"mu": unflatten(params, [x[1] for x in new]),
                 "nu": unflatten(params, [x[2] for x in new]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
