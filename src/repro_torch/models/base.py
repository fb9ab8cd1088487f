"""Declarative parameter trees over torch.

Every module declares its parameters once as a tree (nested dicts and
lists) of :class:`ParamDef` leaves (shape, partition spec, init); the
same declaration is built in three modes, as in JAX, so shapes and
shardings cannot drift apart: :func:`build` materializes the tree on a
device from an explicit ``torch.Generator``, :func:`shape_tree` gives
meta tensors (the dry run's stand-ins, no allocation) and
:func:`spec_tree` the :class:`~repro_torch.models.sharding.P` tree that
``models.spmd.shard_params`` cuts the parameters by.  Weights keep the JAX
package's layouts (``(d_in, d_out)``, used as ``x @ w``) so the tests can
hold the port against it leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.sharding import P


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    scale: float = 1.0          # stddev multiplier for trunc-normal init
    dtype: Any = torch.bfloat16
    init: str = "normal"        # "normal" | "zeros" | "ones"
    spec: P = P()               # canonical partition spec (missing: None)


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


def spec_tree(tree: Any) -> Any:
    """The partition spec of every leaf, one entry per dimension."""
    return map_tree(lambda d: P(*(tuple(d.spec) + (None,) * (
        len(d.shape) - len(d.spec)))), tree)


def shape_tree(tree: Any) -> Any:
    """Meta tensors of every leaf's shape and dtype (no allocation)."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), tree)


def retype_defs(tree: Any, dtype: Any) -> Any:
    """Replace the default bf16 weight dtype with ``dtype`` (test configs
    run fp32); leaves that request another dtype are left alone."""
    def _retype(d: ParamDef) -> ParamDef:
        if d.dtype == torch.bfloat16:
            return dataclasses.replace(d, dtype=dtype)
        return d
    return map_tree(_retype, tree)


def stack_defs(tree: Any, n: int, stack_spec_axis: Any = None) -> Any:
    """Stack a ParamDef tree ``n`` times along a new leading axis (one
    tensor holding every layer's copy, e.g. the paged KV pools), the new
    axis's spec entry ``stack_spec_axis``."""
    return map_tree(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape,
        spec=P(stack_spec_axis, *d.spec)), tree)
