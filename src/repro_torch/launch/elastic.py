"""Elastic re-scaling: rebuild the mesh when the healthy rank count
changes and reshard the checkpoint onto it (the port of
``repro.launch.elastic``).

The recovery path:
  1. the watchdog (train loop) or the platform reports a new rank count;
  2. ``plan_mesh(n)`` picks the largest (data, model) grid that keeps the
     model axis's divisibility constraints;
  3. the latest checkpoint (the full tree: ``train.loop`` gathers it
     before saving) is restored with the NEW model_ax -- restore pads or
     crops each leaf to the new shapes (the vocab padding follows
     ``model_ax``) -- and every rank takes its shard.

``plan_mesh`` is pure and deterministic, so every surviving rank
computes the same plan without coordination.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_devices: int
    data: int
    model: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def _divisors_desc(n: int) -> list[int]:
    return sorted({d for i in range(1, int(n ** 0.5) + 1) if n % i == 0
                   for d in (i, n // i)}, reverse=True)


def plan_mesh(cfg: ModelConfig, n_devices: int,
              prefer_model: int = 16) -> MeshPlan:
    """Largest usable (data, model) grid for the surviving ranks: the
    model axis must divide the ffn (and the query heads); the preferred
    size shrinks by its divisors as ranks are lost."""
    for model in [m for m in _divisors_desc(prefer_model) if m >= 1]:
        if n_devices % model:
            continue
        data = n_devices // model
        if data < 1:
            continue
        ffn = cfg.moe_d_ff or cfg.d_ff or cfg.d_model
        heads_ok = cfg.n_heads == 0 or cfg.n_heads % model == 0
        if ffn % model == 0 and heads_ok:
            return MeshPlan(n_devices, data, model)
    return MeshPlan(n_devices, n_devices, 1)


def make_elastic_mesh(plan: MeshPlan, device: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the first ``plan.n_devices``
    ranks of the world."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(plan.n_devices).reshape(plan.shape)
    return DeviceMesh(device, ranks, mesh_dim_names=("data", "model"))


def reshard_checkpoint(cfg: ModelConfig, ckpt_dir: str, plan: MeshPlan,
                       mesh=None, mapping: dict | None = None,
                       device: str | torch.device = "cpu"):
    """Restore the newest checkpoint under the new mesh's model_ax.

    The template is ``param_shapes(cfg, plan.model)`` (AdamW's moments
    alike, fp32): ``train.checkpoint.restore`` pads or crops every leaf
    to it, as JAX's does.  With ``mesh`` every rank keeps its shards
    (``models.spmd.shard_params`` under ``mapping``, by default the
    batch over "data" and the model axis over "model").  Returns
    ``({"params", "opt"}, step)``."""
    from repro_torch.models import spmd
    from repro_torch.models import transformer as T
    from repro_torch.models.base import map_tree
    from repro_torch.train import checkpoint as ckpt

    shapes = T.param_shapes(cfg, plan.model)
    zeros = lambda dt: (lambda s: torch.zeros(  # noqa
        s.shape, dtype=dt or s.dtype, device=device))
    template = {
        "params": map_tree(zeros(None), shapes),
        "opt": {"mu": map_tree(zeros(torch.float32), shapes),
                "nu": map_tree(zeros(torch.float32), shapes),
                "step": torch.zeros((), dtype=torch.int32, device=device)},
    }
    state, step = ckpt.restore(ckpt_dir, template)
    if mesh is None:
        return state, step
    mapping = mapping or {"data": ("data",), "model": "model"}
    specs = T.param_specs(cfg, plan.model)
    cut = lambda t: spmd.shard_params(t, specs, mesh, mapping)  # noqa
    return {"params": cut(state["params"]),
            "opt": {"mu": cut(state["opt"]["mu"]),
                    "nu": cut(state["opt"]["nu"]),
                    "step": state["opt"]["step"]}}, step
