"""Declarative parameter trees over torch.

Every module declares its parameters once as a tree (nested dicts and
lists) of :class:`ParamDef` leaves; :func:`build` materializes the tree
on a device from an explicit ``torch.Generator``.  Weights keep the JAX
package's layouts (``(d_in, d_out)``, used as ``x @ w``) so the tests can
hold the port against it leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    scale: float = 1.0          # stddev multiplier for trunc-normal init
    dtype: Any = torch.bfloat16
    init: str = "normal"        # "normal" | "zeros" | "ones"


def fan_in_scale(fan_in: int) -> float:
    return fan_in ** -0.5


def map_tree(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def _init_leaf(d: ParamDef, device: torch.device,
               gen: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    t = torch.empty(d.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-3.0, b=3.0, generator=gen)
    return t.mul_(d.scale).to(d.dtype)


def build(tree: Any, device: torch.device,
          generator: torch.Generator | None = None) -> Any:
    """Materialize a ParamDef tree on ``device``.  ``generator`` (a
    generator of that device) draws the "normal" leaves in tree order;
    a tree of only zeros/ones leaves needs none."""
    def leaf(d: ParamDef) -> torch.Tensor:
        if d.init == "normal" and generator is None:
            raise ValueError("random init needs an explicit generator")
        return _init_leaf(d, device, generator)
    return map_tree(leaf, tree)


def retype_defs(tree: Any, dtype: Any) -> Any:
    """Replace the default bf16 weight dtype with ``dtype`` (test configs
    run fp32); leaves that request another dtype are left alone."""
    def _retype(d: ParamDef) -> ParamDef:
        if d.dtype == torch.bfloat16:
            return dataclasses.replace(d, dtype=dtype)
        return d
    return map_tree(_retype, tree)


def stack_defs(tree: Any, n: int) -> Any:
    """Stack a ParamDef tree ``n`` times along a new leading axis (one
    tensor holding every layer's copy, e.g. the paged KV pools)."""
    return map_tree(lambda d: dataclasses.replace(d, shape=(n,) + d.shape),
                    tree)
