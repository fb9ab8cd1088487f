"""Training loop (the port of ``repro.train.loop``): a train step with
gradient accumulation, optional gradient compression and AdamW,
checkpointing, and a straggler watchdog.

PyTorch runs eagerly, so ``make_train_step`` returns a plain function:
the gradients come from ``torch.autograd.grad`` over the parameter
leaves, and accumulation is a Python loop over micro-batches (JAX
scanned them).  Parameters never keep ``requires_grad``: each step takes
detached views that do.  With ``blocked_linear`` the projections run the
blocked GEMM forward and its dgrad kernels backward, and attention runs
the flash forward and backward kernels on the card in every case; with
``use_kernel=False`` (the yardstick a kernel path is held against) every
op takes its plain version and nothing launches.

On a mesh (``make_train_step(..., mesh=, mapping=)``, ``train(...,
mesh=)``) the step takes the rank's shards of the parameters and the
optimizer state (``models.spmd.shard_params`` under JAX's specs) and its
rows of the batch, and runs the model's sharded route
(``models/spmd.py``), even on a mesh of one rank.  The loss is the
masked mean over the global batch; the gradients are reduced over the
batch axes; the clip's global norm counts every distinct shard once; a
micro-batch of the accumulation is the i-th slice of every rank's rows
(JAX slices the global batch, so with a different token count per
micro-batch the two normalise differently).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.models import sharding, spmd
from repro_torch.models import transformer as T
from repro_torch.models.base import map_tree
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.compress import compress_tree
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = False
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 10
    straggler_factor: float = 3.0  # step slower than 3x median -> flag
    blocked_linear: bool = False   # projections through the blocked GEMM
    #   and its dgrad kernels; off by default (torch.matmul, cuBLAS, is
    #   the baseline, as XLA's dot is in JAX)
    use_kernel: bool = True        # False: every op's plain version


def make_loss(cfg: ModelConfig, tc: TrainConfig | None = None) -> Callable:
    """``loss(params, batch) -> (total, metrics)`` with the blocked-linear
    switch live inside it, as JAX sets it inside the traced loss."""
    blocked = bool(tc and tc.blocked_linear)
    use_kernel = tc.use_kernel if tc is not None else True

    def loss(params, batch):
        from repro_torch.kernels import ops
        with ops.blocked_linear(blocked):
            return T.loss_fn(cfg, params, batch, use_kernel=use_kernel)
    return loss


def _value_and_grad(loss: Callable, params: Any, batch: dict):
    """``((total, metrics), grads)`` with grads shaped like params, in
    each parameter's dtype."""
    flat = adamw.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        total, metrics = loss(adamw.unflatten(params, live), batch)
        grads = torch.autograd.grad(total, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), adamw.unflatten(params, list(grads))


def default_mapping(mesh) -> dict:
    """JAX's launcher mapping: the batch over the pod and data axes, the
    model axis (where the mesh has one) for tensor parallelism."""
    from repro_torch.launch.mesh import data_axes
    return {"data": data_axes(mesh),
            "model": "model" if "model" in mesh.mesh_dim_names else None}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                    mapping: dict | None = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``mesh`` (a DeviceMesh; ``mapping`` defaults to
    :func:`default_mapping`) the step runs the sharded route over local
    shards (module docstring)."""
    loss = make_loss(cfg, tc)
    if mesh is not None:
        mapping = mapping or default_mapping(mesh)
    # one scale per JAX tensor: JAX stacks each pattern entry's layers
    groups = T.jax_stacking(cfg) if tc.compress_grads else None

    def train_step(params, opt_state, batch):
        with (sharding.use_mesh(mesh, mapping) if mesh is not None
              else contextlib.nullcontext()) as ctx:
            n = tc.grad_accum
            gsum, ltot, atot = None, 0.0, 0.0
            for i in range(n):
                mb = batch if n == 1 else {
                    k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                    for k, v in batch.items()}
                (_, m), g = _value_and_grad(loss, params, mb)
                if n > 1:
                    g = map_tree(lambda x: x.float(), g)
                gsum = g if gsum is None else adamw.unflatten(
                    gsum, [a + b for a, b in zip(adamw.leaves(gsum),
                                                 adamw.leaves(g))])
                # JAX reports the micro-batches' mean total as "loss"; the
                # mean aux rides beside it for the log
                ltot = ltot + m["loss"] + 0.01 * m["aux"]
                atot = atot + m["aux"]
            grads = gsum
            if ctx is not None:
                specs = T.param_specs(cfg, ctx.model_ax)
                grads = spmd.reduce_grads(grads, specs, ctx)
            if n > 1:
                grads = map_tree(lambda x: x / n, grads)
                metrics = {"loss": ltot / n, "aux": atot / n}
            else:
                metrics = m
            gnorm = None
            if ctx is None:
                if tc.compress_grads:
                    grads, _ = compress_tree(grads, groups=groups)
            else:
                if tc.compress_grads:
                    grads = spmd.compress_tree(grads, specs, ctx, groups)
                gnorm = spmd.global_norm(grads, specs, ctx)
            params, opt_state, opt_m = adamw.apply_updates(
                tc.opt, params, grads, opt_state, gnorm=gnorm)
        metrics = dict(metrics)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return train_step


def shard_state(cfg: ModelConfig, params: Any, opt_state: dict, mesh,
                mapping: dict) -> tuple[Any, dict]:
    """The rank's shards of full parameters and AdamW state under JAX's
    specs at the mapping's model axis."""
    ctx = sharding.MeshContext(mesh, mapping)
    specs = T.param_specs(cfg, ctx.model_ax)
    cut = lambda t: spmd.shard_params(t, specs, mesh, mapping)  # noqa
    return cut(params), {"mu": cut(opt_state["mu"]),
                         "nu": cut(opt_state["nu"]),
                         "step": opt_state["step"]}


def unshard_state(cfg: ModelConfig, state: dict, mesh, mapping: dict) -> dict:
    """The full ``{"params", "opt"}`` tree from every rank's shards (an
    all-gather along every sharded dimension; every rank gets it)."""
    ctx = sharding.MeshContext(mesh, mapping)
    specs = T.param_specs(cfg, ctx.model_ax)
    full = lambda t: spmd.unshard(t, specs, ctx)  # noqa
    return {"params": full(state["params"]),
            "opt": {"mu": full(state["opt"]["mu"]),
                    "nu": full(state["opt"]["nu"]),
                    "step": state["opt"]["step"]}}


def _model_ax(mesh, mapping: dict | None) -> int:
    if mesh is None:
        return 1
    return sharding.MeshContext(mesh, mapping or default_mapping(mesh)
                                ).model_ax


class StepWatchdog:
    """Straggler mitigation hook: tracks step times, flags anomalies.

    On a real cluster the flag triggers microbatch rebalancing or slice
    eviction; here it logs (the decision logic is what can be tested)."""

    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self.times: list[float] = []
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        window = sorted(self.times[-50:])
        median = window[len(window) // 2]
        slow = len(self.times) > 5 and dt > self.factor * median
        if slow:
            self.flags.append(step)
        return slow


def train(cfg: ModelConfig, tc: TrainConfig, batches, *,
          params=None, seed: int = 0, device: str | torch.device = "cuda",
          restore: bool = False, log=print, obs=None, mesh=None,
          mapping: dict | None = None) -> dict:
    """Single-host training loop over ``batches`` (an iterable of
    ``{"tokens", "labels"}`` tensor dicts, with the family's
    ``enc_embeds`` or ``prefix_embeds`` where it has them: every key is
    split along the batch for accumulation).  The log line carries the
    MoE aux loss (0 for the other families).  ``params`` default to
    ``T.init_params(cfg, seed, device)``.

    ``obs`` (a :class:`repro_torch.obs.Obs`, optional) gets JAX's
    training telemetry: ``train.loss`` and ``train.tokens_per_s``
    gauges, a ``train.step_us`` histogram and a ``train.steps`` counter
    in the registry; ``step {n}``, ``grad`` and ``checkpoint`` spans and
    a ``train`` counter track (loss, tokens/s) in the tracer; and, with
    ``blocked_linear``, every projection's schedule resolutions (forward
    and dgrad) in the DRAM ledger under the ``train_step`` scope.  Every
    step ends by reading the loss on the host, which waits for the
    device, as JAX blocks on it: step times and spans are device times
    with or without a tracer.

    With ``mesh`` the loop runs :func:`make_train_step`'s sharded route:
    ``params`` (full; by default drawn as above, the same on every rank)
    are cut into the rank's shards, ``batches`` yield the rank's rows,
    and a checkpoint holds the full tree (gathered; rank 0 writes it),
    restored by every rank and cut again, so a restart may change the
    mesh.
    """
    if params is None:
        params = T.init_params(cfg, seed=seed, device=device,
                               model_ax=_model_ax(mesh, mapping))
    opt_state = adamw.init_state(params)
    start_step = 0
    if restore and tc.ckpt_dir:
        if ckpt.latest_valid(tc.ckpt_dir) is not None:
            state, start_step = ckpt.restore(
                tc.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            log(f"restored checkpoint at step {start_step}")
    if mesh is not None:
        mapping = mapping or default_mapping(mesh)
        params, opt_state = shard_state(cfg, params, opt_state, mesh,
                                        mapping)

    if obs is not None:
        from repro_torch.obs import null_span
        span = obs.tracer.span if obs.tracer is not None else null_span
        g_loss = obs.registry.gauge("train.loss")
        g_tps = obs.registry.gauge("train.tokens_per_s")
        h_step = obs.registry.histogram("train.step_us")
        c_steps = obs.registry.counter("train.steps")

    step_fn = make_train_step(cfg, tc, mesh, mapping)
    watchdog = StepWatchdog(tc.straggler_factor)
    history = []
    for step, batch in enumerate(batches, start=start_step):
        t0 = time.perf_counter()
        if obs is not None:
            with span(f"step {step}", cat="train", args={"step": step}):
                with span("grad", cat="train"), \
                        obs.dram.scope("train_step"):
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    loss = float(metrics["loss"])  # waits for the device
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the device
        dt = time.perf_counter() - t0
        slow = watchdog.observe(step, dt)
        if obs is not None:
            tps = batch["tokens"].numel() / dt if dt > 0 else 0.0
            g_loss.set(loss)
            g_tps.set(round(tps, 1))
            h_step.observe(dt * 1e6)
            c_steps.inc()
            obs.dram.end_step()
            if obs.tracer is not None:
                obs.tracer.counter("train", {"loss": loss,
                                             "tokens_per_s": tps})
        if step % tc.log_every == 0 or slow:
            log(f"step {step:5d} loss {loss:.4f} "
                f"aux {float(metrics.get('aux', 0)):.4f} "
                f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                f"{dt*1e3:.0f}ms" + ("  [STRAGGLER]" if slow else ""))
        history.append(loss)
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            with (span("checkpoint", cat="train", args={"step": step + 1})
                  if obs is not None else contextlib.nullcontext()):
                state = {"params": params, "opt": opt_state}
                if mesh is not None:
                    state = unshard_state(cfg, state, mesh, mapping)
                if mesh is None or torch.distributed.get_rank() == 0:
                    ckpt.save_async(tc.ckpt_dir, step + 1, state)
    ckpt.wait_async()
    return {"params": params, "opt": opt_state, "history": history,
            "straggler_flags": watchdog.flags}
