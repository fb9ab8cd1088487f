"""Rank functions for ``tests/test_torch_distributed.py``.

Each runs in a process of its own (``torch.multiprocessing.spawn``),
joins a gloo group through a ``FileStore`` file (no TCP port: the suite
runs under xdist), and imports only torch, numpy and the port: JAX's
values come from the parent in an ``.npz``, and rank 0 writes what it
measured to a JSON file the parent holds to the tolerances.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.distributed as dist


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.abs(b).max()
    return float(np.abs(a - b).max() / den) if den else float(
        np.abs(a).max())


def _adam_excess(new, want, grads, clip: float, lr: float,
                 eps: float = 1e-8, tol: float = 1e-5,
                 atol: float | None = None) -> float:
    """How far the params after one AdamW step (from a zero state) stand
    from JAX's, in units of the bound: ``tol`` of the leaf's max (with
    ``atol``: ``atol + tol |want|`` elementwise), plus what the
    gradient's error under the same bound, ``d``, moves the first update
    ``g / (|g| + eps)`` by, ``lr * eps * d / (|g| - d + eps)^2`` (at
    most ``2 lr``), ``g`` clip-scaled.  That term matters only where
    |g| is near ``eps``, where the update turns on the gradient's
    rounding.  1 or less passes."""
    a, b, g = (np.asarray(x, np.float64) for x in (new, want, grads))
    g = np.abs(g * clip)
    if atol is None:
        d, base = tol * g.max(), tol * np.abs(b).max()
    else:
        d, base = atol + tol * g, atol + tol * np.abs(b)
    sens = np.minimum(2.0, eps * d / (np.maximum(g - d, 0) + eps) ** 2)
    bound = base + lr * sens
    return float((np.abs(a - b) / bound).max())


def _excess(a, b, atol: float, rtol: float) -> float:
    """max |a - b| / (atol + rtol |b|): 1 or less passes."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _tensors(tree):
    from repro_torch.optim.adamw import leaves
    return [t.detach().float().numpy() for t in leaves(tree)]


def _cfg(arch: str, **over):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), dtype=torch.float32,
                               **over)


def _rows(ctx, x):
    """This rank's rows of a global batch (split over the batch axes)."""
    from repro_torch.models.sharding import group_index
    if ctx.batch_group is None:
        return x
    n = ctx.batch_size
    return x.reshape(n, -1, *x.shape[1:])[group_index(ctx.batch_group)]


MAPPINGS = {"tp_fsdp": {"data": ("data",), "model": "model"},
            "fsdp": {"data": ("data", "model"), "model": None}}


def train_cases(rank: int, world: int, store: str, shape: tuple,
                data: str, out: str) -> None:
    """One step of the sharded train step per case of the parent's
    ``.npz`` (both parallelisms): the loss, every gradient leaf
    (gathered) and the parameters after AdamW against JAX's."""
    _join(rank, world, store)
    result = _train_results(shape, data)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def _train_results(shape: tuple, data: str) -> dict:
    """:func:`train_cases`' measurements.  A case's ``pars`` names its
    parallelisms (default both); its batch is every ``batch/`` array
    (the families' stub inputs too).  Errors are relative (max |port -
    JAX| over max |JAX|) or, where the case has ``tol`` (atol, rtol),
    in units of ``atol + rtol |JAX|`` elementwise (:func:`_excess`)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, spmd
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cases = json.loads(open(data + ".json").read())
    arrays = np.load(data)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    result = {}
    for name, case in cases.items():
        cfg = _cfg(case["arch"], **case.get("cfg", {}))
        tree = _unflat(arrays, f"{name}/params/")
        batch = {k: torch.from_numpy(v) for k, v in
                 _unflat(arrays, f"{name}/batch/").items()}
        tol = case.get("tol")
        err = (lambda a, b: _excess(a, b, *tol)) if tol else _rel
        for par in case.get("pars", list(MAPPINGS)):
            mapping = MAPPINGS[par]
            ctx = sharding.MeshContext(mesh, mapping)
            full = params_from_numpy(cfg, tree, device="cpu")
            specs = T.param_specs(cfg, ctx.model_ax)
            params = spmd.shard_params(full, specs, mesh, mapping)
            local = {k: _rows(ctx, v) for k, v in batch.items()}
            tc = loop.TrainConfig(
                opt=adamw.AdamWConfig(**case["opt"]),
                grad_accum=case.get("accum", 1),
                compress_grads=case.get("compress", False))
            if tc.grad_accum == 1:
                with sharding.use_mesh(mesh, mapping):
                    (_, m), g = loop._value_and_grad(
                        loop.make_loss(cfg, tc), params, local)
                    grads = spmd.unshard(spmd.reduce_grads(g, specs, ctx),
                                         specs, ctx)
            step = loop.make_train_step(cfg, tc, mesh, mapping)
            state = adamw.init_state(params)
            new, _, metrics = step(params, state, local)
            new = spmd.unshard(new, specs, ctx)
            want_g = params_from_numpy(cfg, _unflat(
                arrays, f"{name}/grads/"), device="cpu")
            want_p = params_from_numpy(cfg, _unflat(
                arrays, f"{name}/new/"), device="cpu")
            gnorm = float(arrays[f"{name}/grad_norm"])
            clip = min(1.0, tc.opt.clip_norm / (gnorm + 1e-9))
            adam = dict(tol=tol[1], atol=tol[0]) if tol else {}
            r = {"loss": err(float(metrics["loss"]),
                             float(arrays[f"{name}/loss"])),
                 "grad_norm": err(float(metrics["grad_norm"]), gnorm),
                 "params_in_bound": max(_adam_excess(
                     a, b, g, clip, tc.opt.lr, **adam) for a, b, g in zip(
                         _tensors(new), _tensors(want_p),
                         _tensors(want_g)))}
            if tc.grad_accum == 1:
                r["loss_first"] = err(float(m["loss"]),
                                      float(arrays[f"{name}/loss"]))
                r["grads"] = max(err(a, b) for a, b in zip(
                    _tensors(grads), _tensors(want_g)))
            result[f"{name}/{par}"] = r
    return result


def _unflat(arrays, prefix: str):
    """The tree saved under ``prefix`` by the parent's ``flat``."""
    tree: dict = {}
    for key in arrays.files:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrays[key]
    return _lists(tree)


def _lists(node):
    """Dicts keyed "0", "1", ... back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def serve_cases(rank: int, world: int, store: str, shape: tuple,
                data: str, out: str) -> None:
    """``prefill`` and ``decode_step`` s on the mesh per case: the
    rank's rows of the logits against JAX's unsharded ones (relative),
    and the attention layers' cache layouts."""
    _join(rank, world, store)
    result = _serve_results(shape, data)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def _serve_results(shape: tuple, data: str) -> dict:
    """:func:`serve_cases`' measurements.  ``next`` is (B,) (one step) or
    (B, n) (n steps from the prompt's end, the prefix's positions
    counted); a case's ``extra/`` arrays (the stub inputs) go to
    ``prefill``; ``prefill`` checks every cache shard against
    ``cache_specs``."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, spmd
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import _cache_layout
    cases = json.loads(open(data + ".json").read())
    arrays = np.load(data)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    mapping = MAPPINGS["tp_fsdp"]
    ctx = sharding.MeshContext(mesh, mapping)
    result = {}
    for name, case in cases.items():
        cfg = _cfg(case["arch"], **case.get("cfg", {}))
        m = ctx.model_ax
        full = params_from_numpy(cfg, _unflat(arrays, f"{name}/params/"),
                                 device="cpu", model_ax=m)
        params = spmd.shard_params(full, T.param_specs(cfg, m), mesh,
                                   mapping)
        tokens = torch.from_numpy(arrays[f"{name}/tokens"])
        extra = {k: _rows(ctx, torch.from_numpy(v)) for k, v in
                 _unflat(arrays, f"{name}/extra/").items()}
        nxt = torch.from_numpy(arrays[f"{name}/next"])
        nxt = nxt.reshape(nxt.shape[0], -1)
        want = torch.from_numpy(arrays[f"{name}/decode"])
        want = want.reshape(nxt.shape + want.shape[-1:])
        max_seq = case["max_seq"]
        s = tokens.shape[1] + cfg.prefix_tokens
        with sharding.use_mesh(mesh, mapping), torch.no_grad():
            logits, cache = T.prefill(cfg, params, _rows(ctx, tokens),
                                      max_seq, use_kernel=False, **extra)
            layouts = sorted({_cache_layout(
                cfg, min(cfg.window, max_seq) if cfg.mixer_for_layer(i)
                == "local" else max_seq, m)
                for i in T.attention_layers(cfg)})
            dec = []
            for j in range(nxt.shape[1]):
                out_j, cache = T.decode_step(
                    cfg, params, _rows(ctx, nxt[:, j]), cache, s + j,
                    use_kernel=False, max_seq=max_seq)
                dec.append(_rel(out_j.numpy(),
                                _rows(ctx, want[:, j]).numpy()))
        result[name] = {
            "prefill": _rel(logits.numpy(), _rows(ctx, torch.from_numpy(
                arrays[f"{name}/prefill"])).numpy()),
            "decode": max(dec), "layouts": layouts}
    return result


def family_cases(rank: int, world: int, store: str, shape: tuple,
                 train: str, serve: str | None, out: str) -> None:
    """The families' training cases (:func:`train_cases`) and, where
    ``serve`` names a file, their serving cases (:func:`serve_cases`)
    in one group: ``{"train": ..., "serve": ...}``."""
    _join(rank, world, store)
    result = {"train": _train_results(shape, train)}
    if serve:
        result["serve"] = _serve_results(shape, serve)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def moe_cases(rank: int, world: int, store: str, shape: tuple, data: str,
              out: str) -> None:
    """``layers.moe_apply`` on the mesh (the shard-mapped dispatch) over
    the rank's rows, per capacity factor of the parent's cases: output
    (gathered over the batch axes) and aux."""
    _join(rank, world, store)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import sharding, spmd
    from repro_torch.models.base import spec_tree
    cases = json.loads(open(data + ".json").read())
    arrays = np.load(data)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    mapping = MAPPINGS["tp_fsdp"]
    ctx = sharding.MeshContext(mesh, mapping)
    result = {}
    for name, case in cases.items():
        cfg = _cfg("qwen3-moe-235b-a22b",
                   capacity_factor=case["capacity_factor"])
        full = {k: torch.from_numpy(arrays[f"params/{k}"])
                for k in ("router", "w_gate", "w_up", "w_down")}
        specs = spec_tree(L.moe_defs(cfg, 2))
        params = spmd.shard_params(full, specs, mesh, mapping)
        x = torch.from_numpy(arrays["x"])
        with sharding.use_mesh(mesh, mapping), torch.no_grad():
            local = spmd.gather_tree(params, specs, ctx)
            got, aux = L.moe_apply(cfg, local, _rows(ctx, x))
            on_mesh = sharding.on_mesh()
            if ctx.batch_group is not None:
                got = spmd.all_gather(got, 0, ctx.batch_group)
        want = arrays[f"{name}/{shape[0]}x{shape[1]}/out"]
        want_aux = float(arrays[f"{name}/{shape[0]}x{shape[1]}/aux"])
        result[name] = {"out": float(np.abs(got.numpy() - want).max()),
                        "aux": abs(float(aux) - want_aux),
                        "sharded": on_mesh}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def save_checkpoint(rank: int, world: int, store: str, shape: tuple,
                    arch_over: dict, ckpt_dir: str, out: str) -> None:
    """One sharded train step on ``shape`` at model_ax = its model axis,
    saved (the full tree, rank 0) to ``ckpt_dir`` at step 1."""
    _join(rank, world, store)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding
    from repro_torch.train import loop
    cfg = _cfg("granite-3-8b", **arch_over)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    mapping = MAPPINGS["tp_fsdp"]
    ctx = sharding.MeshContext(mesh, mapping)
    batch = make_batch(cfg, 16, 4, 0, device="cpu")
    tc = loop.TrainConfig(ckpt_dir=ckpt_dir, ckpt_every=1)
    loop.train(cfg, tc, [{k: _rows(ctx, v) for k, v in batch.items()}],
               device="cpu", mesh=mesh, mapping=mapping,
               log=lambda *a: None)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"ok": True}, f)
    dist.destroy_process_group()


def restore_checkpoint(rank: int, world: int, store: str, shape: tuple,
                       arch_over: dict, ckpt_dir: str, out: str) -> None:
    """``elastic.reshard_checkpoint`` onto ``plan_mesh``'s (data, model)
    mesh of ``world`` ranks; the shards gathered back, saved by rank 0."""
    _join(rank, world, store)
    from repro_torch.launch import elastic
    from repro_torch.models import sharding, spmd
    from repro_torch.models import transformer as T
    cfg = _cfg("granite-3-8b", **arch_over)
    plan = elastic.MeshPlan(world, *shape)
    mesh = elastic.make_elastic_mesh(plan, "cpu")
    mapping = MAPPINGS["tp_fsdp"]
    state, step = elastic.reshard_checkpoint(cfg, ckpt_dir, plan, mesh,
                                             mapping)
    ctx = sharding.MeshContext(mesh, mapping)
    specs = T.param_specs(cfg, plan.model)
    full = spmd.unshard(state["params"], specs, ctx)
    mu = spmd.unshard(state["opt"]["mu"], specs, ctx)
    if rank == 0:
        flat = {}
        for prefix, tree in (("params", full), ("mu", mu)):
            for i, t in enumerate(_tensors(tree)):
                flat[f"{prefix}/{i}"] = t
        np.savez(out, step=step, **flat)
    dist.destroy_process_group()

