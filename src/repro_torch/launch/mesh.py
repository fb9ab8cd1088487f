"""Meshes of the port (the port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
data=16, model=16) = 512 ranks; the ``pod`` axis is pure data
parallelism.  A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
default process group, which the caller has initialised (``torchrun``
gives each rank its place through the environment; the dry run uses the
fake backend).  The device type is ``"cuda"`` unless the caller asks
for ``"cpu"``.  :class:`AbstractMesh` has the axis names and sizes only,
for the pure functions (``data_axes``, ``batch_divisor``,
``launch.shapes.axis_mapping``), as JAX's ``AbstractMesh``.

Defined as functions, so importing this module touches no process
group.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.models.sharding import axis_sizes


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without ranks: ``AbstractMesh((16, 16), ("data",
    "model"))``."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default
    process group, which must hold exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs "
                           f"{need} ranks; this world has {world}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: str = "cuda"):
    """Every rank of the world (tests, the launcher): a data-only mesh."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n,), ("data",), device)


def data_axes(mesh) -> tuple[str, ...]:
    """The axes that carry the batch dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def batch_divisor(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n
