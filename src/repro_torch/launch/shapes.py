"""Stand-ins and shardings for every (arch x shape) cell (the port of
``repro.launch.shapes``).

``input_specs(cfg, shape, mesh)`` returns a :class:`Lowerable`: the
function the dry run runs and its arguments as meta tensors at the
rank's **local** shapes (JAX hands XLA global shapes and shardings; the
port's sharded route takes local shards):

* train_*    -> train_step(params, opt_state, batch)
* prefill_*  -> prefill(params, batch)
* decode_* / long_* -> decode_step(params, token, cache, pos)

Spec translation: model code writes specs with the canonical axis names
("data", "model"); :func:`axis_mapping` rewrites them per mesh and cell
-- "data" becomes ("pod", "data") on the multi-pod mesh, or None where
the batch cannot be split (batch-1 long-context decode).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import SHAPES, Shape
from repro_torch.launch.mesh import batch_divisor, data_axes
from repro_torch.models import transformer as T
from repro_torch.models.base import map_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (P, axis_sizes, entry_axes,
                                         local_shape, map_specs,
                                         translate_tree)


def axis_mapping(cfg: ModelConfig, shape: Shape, mesh,
                 parallelism: str = "tp_fsdp") -> dict[str, Any]:
    """How the canonical axes map onto this mesh for this cell.

    ``tp_fsdp`` (default): "model" -> the tensor-parallel axis, "data"
    -> batch + FSDP.  ``fsdp``: no tensor parallelism -- the model axis
    is folded into data (pure ZeRO-3): for dense models at large token
    batches the per-layer activation all-reduces (O(tokens x d_model))
    become weight all-gathers (O(params)), far less traffic when
    tokens/rank x d >> params/rank.
    """
    sizes = axis_sizes(mesh)
    size = 1
    for n in sizes.values():
        size *= n
    if parallelism == "fsdp":
        axes = tuple(mesh.mesh_dim_names)  # every axis: batch + FSDP
        if shape.global_batch % size == 0:
            return {"model": None, "data": axes}
        return {"model": None, "data": ("data",)
                if shape.global_batch % sizes.get("data", 1) == 0
                else None}
    mapping: dict[str, Any] = {"model": "model"}
    if shape.global_batch % batch_divisor(mesh) == 0:
        mapping["data"] = data_axes(mesh)
    elif shape.global_batch % sizes.get("data", 1) == 0:
        mapping["data"] = ("data",)
    else:
        mapping["data"] = None  # batch too small to split (long_500k b=1)
    return mapping


def shardings_of(tree_specs: Any, mesh, mapping: dict) -> Any:
    """DTensor placements of every spec (one per mesh dimension:
    ``Shard(d)`` where tensor dimension d splits over it, else
    ``Replicate()``) -- bookkeeping; the hot path never sees a
    DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)

    def place(spec: P):
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            for a in entry_axes(entry):
                out[names.index(a)] = Shard(dim)
        return tuple(out)
    return map_specs(place, translate_tree(tree_specs, mapping))


def batch_shapes(cfg: ModelConfig, shape: Shape) -> tuple[dict, dict]:
    """(meta tensors at global shapes, specs) of a train/prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda *sh, dt=torch.int32: torch.empty(  # noqa
        sh, dtype=dt, device="meta")
    shapes = {"tokens": meta(b, s), "labels": meta(b, s)}
    specs = {"tokens": P("data", None), "labels": P("data", None)}
    if cfg.is_encdec:
        shapes["enc_embeds"] = meta(b, cfg.encoder_seq, cfg.d_model,
                                    dt=cfg.dtype)
        specs["enc_embeds"] = P("data", None, None)
    if cfg.prefix_tokens:
        shapes["prefix_embeds"] = meta(b, cfg.prefix_tokens, cfg.d_model,
                                       dt=cfg.dtype)
        specs["prefix_embeds"] = P("data", None, None)
    return shapes, specs


def local_meta(shapes: Any, specs: Any, mesh, mapping: dict) -> Any:
    """Meta tensors at the rank's local shapes of global ``shapes``."""
    sizes = axis_sizes(mesh)
    tspecs = translate_tree(specs, mapping)

    def zip_map(t, s):
        if isinstance(t, dict):
            return {k: zip_map(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [zip_map(v, x) for v, x in zip(t, s)]
        return torch.empty(local_shape(tuple(t.shape), s, sizes),
                           dtype=t.dtype, device="meta")
    return zip_map(shapes, tspecs)


@dataclasses.dataclass
class Lowerable:
    """Everything the dry run needs to run one cell."""
    fn: Any
    args_shapes: tuple          # meta tensors, the rank's local shapes
    args_specs: tuple           # canonical specs of the arguments
    in_shardings: tuple         # placements (bookkeeping)
    out_shardings: Any
    kind: str
    mapping: dict


def input_specs(cfg: ModelConfig, shape_name: str, mesh,
                model_ax: int | None = None,
                parallelism: str = "tp_fsdp") -> Lowerable:
    """The cell's function and local arguments on ``mesh`` (a DeviceMesh
    to run it; an ``AbstractMesh`` gives the arguments only).  The
    functions take every kernel's plain version by name
    (``use_kernel=False``): meta tensors have no device."""
    shape = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    if parallelism == "fsdp":
        model_ax = 1  # no TP: build specs with the model axis collapsed
    else:
        model_ax = model_ax or sizes.get("model", 1)
    mapping = axis_mapping(cfg, shape, mesh, parallelism)

    pspecs = T.param_specs(cfg, model_ax)
    pshapes = T.param_shapes(cfg, model_ax)
    pshard = shardings_of(pspecs, mesh, mapping)
    params = local_meta(pshapes, pspecs, mesh, mapping)

    if shape.kind == "train":
        from repro_torch.train.loop import TrainConfig, make_train_step
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa
                                    device="meta")
        opt = {"mu": map_tree(f32, params), "nu": map_tree(f32, params),
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        ospecs = {"mu": pspecs, "nu": pspecs, "step": P()}
        bshapes, bspecs = batch_shapes(cfg, shape)
        batch = local_meta(bshapes, bspecs, mesh, mapping)
        step = None
        if hasattr(mesh, "get_group"):
            step = make_train_step(cfg, TrainConfig(use_kernel=False), mesh,
                                   mapping)
        return Lowerable(
            fn=step, args_shapes=(params, opt, batch),
            args_specs=(pspecs, ospecs, bspecs),
            in_shardings=(pshard, shardings_of(ospecs, mesh, mapping),
                          shardings_of(bspecs, mesh, mapping)),
            out_shardings=(pshard, None, None), kind="train",
            mapping=mapping)

    from repro_torch.models.sharding import use_mesh

    if shape.kind == "prefill":
        bshapes, bspecs = batch_shapes(cfg, shape)
        batch = local_meta(bshapes, bspecs, mesh, mapping)
        max_seq = shape.seq_len + cfg.prefix_tokens  # VLM prefix included
        cspecs = T.cache_specs(cfg, shape.global_batch, max_seq, model_ax,
                               cfg.encoder_seq)

        def prefill_fn(params, batch):
            with use_mesh(mesh, mapping), torch.no_grad():
                return T.prefill(cfg, params, batch["tokens"], max_seq,
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 enc_embeds=batch.get("enc_embeds"),
                                 use_kernel=False)

        return Lowerable(
            fn=prefill_fn, args_shapes=(params, batch),
            args_specs=(pspecs, bspecs),
            in_shardings=(pshard, shardings_of(bspecs, mesh, mapping)),
            out_shardings=(None, shardings_of(cspecs, mesh, mapping)),
            kind="prefill", mapping=mapping)

    # decode: one new token against a seq_len KV cache
    b = shape.global_batch
    cshapes = T.cache_shapes(cfg, b, shape.seq_len, model_ax,
                             cfg.encoder_seq)
    cspecs = T.cache_specs(cfg, b, shape.seq_len, model_ax, cfg.encoder_seq)
    cache = local_meta(cshapes, cspecs, mesh, mapping)
    tok = local_meta({"t": torch.empty((b,), dtype=torch.int32,
                                       device="meta")},
                     {"t": P("data")}, mesh, mapping)["t"]
    pos = shape.seq_len - 1

    def decode_fn(params, token, cache, pos):
        with use_mesh(mesh, mapping), torch.no_grad():
            return T.decode_step(cfg, params, token, cache, pos,
                                 use_kernel=False, max_seq=shape.seq_len)

    return Lowerable(
        fn=decode_fn, args_shapes=(params, tok, cache, pos),
        args_specs=(pspecs, P("data"), cspecs, None),
        in_shardings=(pshard, shardings_of(P("data"), mesh, mapping),
                      shardings_of(cspecs, mesh, mapping), None),
        out_shardings=(None, shardings_of(cspecs, mesh, mapping)),
        kind="decode", mapping=mapping)
