"""Mesh-aware sharding helpers (the port of ``repro.models.sharding``).

Model code writes partition specs against *canonical* axis names
("data", "model").  The caller installs an axis mapping per mesh
(multi-pod: "data" -> ("pod", "data"); unshardable batch: "data" ->
None; pure FSDP: "model" -> None) and every spec is translated through
it, so one model definition runs on any mesh layout.

A spec is a :class:`P`: one entry per tensor dimension, each a mesh axis
name, a tuple of them (the dimension split over their product, the
first the major one), or None (replicated).  JAX hands such specs to
XLA's partitioner; PyTorch has none in front of the port's kernels, so
the port partitions explicitly (``models/spmd.py``): every rank holds
the local shards of these specs as plain tensors.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or, where no
process group is needed, ``launch.mesh.AbstractMesh``: names and sizes
only).  :func:`use_mesh` makes one active with its mapping;
:func:`active` returns it (None off a mesh) and :func:`on_mesh` keeps
JAX's meaning: a mesh of more than one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_AXIS_MAPPING: dict[str, Any] = {}


def set_axis_mapping(mapping: dict[str, Any]) -> None:
    global _AXIS_MAPPING
    _AXIS_MAPPING = dict(mapping)


def get_axis_mapping() -> dict[str, Any]:
    return dict(_AXIS_MAPPING)


def translate_spec(spec: P, mapping: dict[str, Any] | None = None) -> P:
    """``spec`` with every canonical name replaced by its mapping (a name
    missing from the mapping stays as it is)."""
    mapping = _AXIS_MAPPING if mapping is None else mapping

    def tr(axis):
        if isinstance(axis, (tuple, list)):
            out = []
            for a in axis:
                m = mapping.get(a, a)
                if m is None:
                    continue
                out.extend(m if isinstance(m, tuple) else (m,))
            return tuple(out) if out else None
        return mapping.get(axis, axis)

    return P(*(tr(a) for a in spec))


def map_specs(fn, tree: Any) -> Any:
    """``fn`` on every :class:`P` leaf of a tree of dicts and lists."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    return tree


def translate_tree(tree: Any, mapping: dict[str, Any] | None = None) -> Any:
    return map_specs(lambda s: translate_spec(s, mapping), tree)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one translated spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: P) -> tuple[str, ...]:
    """Every mesh axis a translated spec shards over."""
    return tuple(a for e in spec for a in entry_axes(e))


# ------------------------------ meshes ------------------------------------


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh, in mesh
    order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def local_shape(shape: tuple[int, ...], spec: P,
                sizes: dict[str, int]) -> tuple[int, ...]:
    """The local shard's shape of a ``shape`` tensor under a translated
    ``spec`` (a dimension that its axes do not divide raises)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if dim % n:
            raise ValueError(f"dimension {dim} of {shape} does not split "
                             f"over {entry_axes(entry)} ({n} ways)")
        out.append(dim // n)
    return tuple(out)


def axis_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates
    on every axis but ``axes``, ranked by their combined index over
    ``axes`` (row-major, the first the major one, as JAX splits a
    dimension over a tuple of axes).  Created on first use: every rank
    asks in the same order, and kept on the mesh."""
    names = tuple(mesh.mesh_dim_names)
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} are not in mesh order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        import torch.distributed as dist
        ranks = mesh.mesh
        rest = [i for i, n in enumerate(names) if n not in axes]
        into = [names.index(a) for a in axes]
        rows = ranks.permute(*rest, *into).reshape(
            -1, math.prod(ranks.shape[i] for i in into))
        groups[axes] = dist.new_subgroups_by_enumeration(
            [r.tolist() for r in rows])[0]
    return groups[axes]


def group_index(group) -> int:
    """This rank's index in ``group`` (its shard along the group's
    axes)."""
    import torch.distributed as dist
    return dist.get_group_rank(group, dist.get_rank())


# --------------------------- the active mesh ------------------------------


@dataclasses.dataclass
class MeshContext:
    """A mesh with its axis mapping, as the sharded model code reads it.

    ``batch_axes``: the mesh axes that split the batch (translated
    "data"); ``model_axis``: the tensor-parallel axis (translated
    "model", None without tensor parallelism); ``model_ax``: its size,
    the ``model_ax`` the specs are built at."""
    mesh: Any
    mapping: dict[str, Any]

    def __post_init__(self):
        self.sizes = axis_sizes(self.mesh)
        self.batch_axes = entry_axes(translate_spec(
            P("data"), self.mapping)[0])
        model = translate_spec(P("model"), self.mapping)[0]
        if isinstance(model, tuple):
            raise ValueError(f"the model axis maps to {model}: one mesh "
                             "axis or None")
        self.model_axis = model
        self.model_ax = self.sizes[model] if model else 1

    @property
    def size(self) -> int:
        return math.prod(self.sizes.values())

    def group(self, axes: tuple[str, ...]):
        return axis_group(self.mesh, tuple(axes)) if axes else None

    def translate(self, spec: P) -> P:
        return translate_spec(spec, self.mapping)

    @property
    def model_group(self):
        return self.group((self.model_axis,)) if self.model_axis else None

    @property
    def batch_group(self):
        return self.group(self.batch_axes)

    @property
    def batch_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.batch_axes)


_ACTIVE: list[MeshContext] = []


@contextlib.contextmanager
def use_mesh(mesh, mapping: dict[str, Any]):
    """Run the model's sharded route on ``mesh`` under ``mapping`` inside
    this context (the axis mapping of :func:`get_axis_mapping` is set
    too, as JAX's launchers set it)."""
    ctx = MeshContext(mesh, mapping)
    prev = get_axis_mapping()
    set_axis_mapping(mapping)
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()
        set_axis_mapping(prev)


def active() -> MeshContext | None:
    """The active mesh (:func:`use_mesh`), None off a mesh."""
    return _ACTIVE[-1] if _ACTIVE else None


def on_mesh() -> bool:
    """True under :func:`use_mesh` with more than one rank."""
    ctx = active()
    return ctx is not None and ctx.size > 1


def maybe_shard(x: torch.Tensor, spec: P,
                shape: tuple[int, ...]) -> torch.Tensor:
    """On a mesh, check that ``x`` is the local shard of a ``shape``
    tensor under ``spec`` (canonical names, translated here) and return
    it; off a mesh, return ``x``."""
    ctx = active()
    if ctx is None:
        return x
    want = local_shape(tuple(shape), ctx.translate(spec), ctx.sizes)
    if tuple(x.shape) != want:
        raise ValueError(f"local shard {tuple(x.shape)} is not the "
                         f"{want} shard of {tuple(shape)} under {spec}")
    return x
