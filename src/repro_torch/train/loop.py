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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

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


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    loss = make_loss(cfg, tc)

    def train_step(params, opt_state, batch):
        if tc.grad_accum > 1:
            n = tc.grad_accum
            gsum, ltot = None, 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, _), g = _value_and_grad(loss, params, mb)
                g32 = map_tree(lambda x: x.float(), g)
                gsum = g32 if gsum is None else adamw.unflatten(
                    gsum, [a + b for a, b in zip(adamw.leaves(gsum),
                                                 adamw.leaves(g32))])
                ltot = ltot + l
            grads = map_tree(lambda x: x / n, gsum)
            metrics = {"loss": ltot / n}
        else:
            (_, metrics), grads = _value_and_grad(loss, params, batch)

        if tc.compress_grads:
            grads, _ = compress_tree(grads)

        params, opt_state, opt_m = adamw.apply_updates(
            tc.opt, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return train_step


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
          restore: bool = False, log=print, registry=None) -> dict:
    """Single-host training loop over ``batches`` (an iterable of
    ``{"tokens", "labels"}`` tensor dicts).  ``params`` default to
    ``T.init_params(cfg, seed, device)``.

    ``registry`` (a :class:`repro_torch.obs.MetricsRegistry`, optional)
    gets JAX's training telemetry: ``train.loss`` and
    ``train.tokens_per_s`` gauges, a ``train.step_us`` histogram and a
    ``train.steps`` counter.  Every step ends by reading the loss on the
    host, which waits for the device, as JAX blocks on it: step times are
    device times.
    """
    if params is None:
        params = T.init_params(cfg, seed=seed, device=device)
    opt_state = adamw.init_state(params)
    start_step = 0
    if restore and tc.ckpt_dir:
        if ckpt.latest_valid(tc.ckpt_dir) is not None:
            state, start_step = ckpt.restore(
                tc.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            log(f"restored checkpoint at step {start_step}")

    if registry is not None:
        g_loss = registry.gauge("train.loss")
        g_tps = registry.gauge("train.tokens_per_s")
        h_step = registry.histogram("train.step_us")
        c_steps = registry.counter("train.steps")

    step_fn = make_train_step(cfg, tc)
    watchdog = StepWatchdog(tc.straggler_factor)
    history = []
    for step, batch in enumerate(batches, start=start_step):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the device
        dt = time.perf_counter() - t0
        slow = watchdog.observe(step, dt)
        if registry is not None:
            tps = batch["tokens"].numel() / dt if dt > 0 else 0.0
            g_loss.set(loss)
            g_tps.set(round(tps, 1))
            h_step.observe(dt * 1e6)
            c_steps.inc()
        if step % tc.log_every == 0 or slow:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                f"{dt*1e3:.0f}ms" + ("  [STRAGGLER]" if slow else ""))
        history.append(loss)
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            ckpt.save_async(tc.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    ckpt.wait_async()
    return {"params": params, "opt": opt_state, "history": history,
            "straggler_flags": watchdog.flags}
