"""Driver ``train``: back-to-back steps of the port's training step
(``train.loop.make_train_step`` at ``TrainConfig()``'s defaults, AdamW).

Set-up builds one step function with its parameters and optimizer
state and drives it through its first three steps on the window's own
feed; the window then carries on with that same state.  Steps are
dispatched without a host sync; the device is synchronised at both ends
of the window, so the steps counted are the steps completed.

The check: the plain reference repeats the first three steps from the
same weights and batches, once the window is over and the program's
state is freed.  Compared: each step's loss; every leaf's first
gradient as the optimizer took it (from the first moment after step 1,
mu / (1 - b1)); every leaf's change over the three steps; every leaf's
float32 first and second moments after the three steps (copied to the
host at set-up, so the window runs on the program's memory alone).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, devtrace, e2e, model, traffic, weights
from portbench.harness import Check, Outcome, sync
from portbench.reference import dense

CHECKED_STEPS = 3


def batch(ctx, vocab: int, step: int) -> dict:
    rows = traffic.batch_rows(ctx.mix, ctx.seed, step, vocab,
                              ctx.device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _norms(tensors) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).tolist()


def opt_dict(opt) -> dict:
    return {k: getattr(opt, k) for k in (
        "lr", "b1", "b2", "eps", "weight_decay", "clip_norm",
        "warmup_steps", "total_steps", "min_lr_frac")}


def run(ctx) -> Outcome:
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, make_train_step
    mix, dev = ctx.mix, ctx.device
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(mix["kernels"])
    cfg = model.model_config(ctx.config, remat=mix["remat"])
    tc = TrainConfig()
    spans = devtrace.Spans()
    params = weights.make(T.model_defs(cfg), ctx.seed, dev)
    start = adamw.leaves(params)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(cfg, tc)
    losses, grad_norms = [], None
    for s in range(CHECKED_STEPS):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch(ctx, cfg.vocab, s))
        losses.append(m["loss"])
        if s == 0:
            grad_norms = [g / (1 - tc.opt.b1)
                          for g in _norms(adamw.leaves(opt_state["mu"]))]
    change = _norms(p.float() - q.float()
                    for p, q in zip(adamw.leaves(params), start))
    moments = {k: [t.to("cpu") for t in adamw.leaves(opt_state[k])]
               for k in ("mu", "nu")}
    losses = [float(x) for x in losses]
    del start
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    tw = None
    if ctx.trace:    # the profiler runs from before the window to after it
        tw = devtrace.Window(torch)
        tw.open()

    steps, s = 0, CHECKED_STEPS
    in_trace = 0
    tw_state = 0
    at = mix["trace"]
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        if tw is not None:
            now = time.perf_counter()
            if tw_state == 0 and now - t0 >= at["start_share"] * ctx.seconds:
                with spans("sync"):
                    tw.mark_start()
                tw_state = 1
            elif tw_state == 1 and now - tw.t0 >= at["seconds"]:
                with spans("sync"):
                    tw.mark_end()
                tw_state = 2
        with spans("batch"):
            b = batch(ctx, cfg.vocab, s)
        with spans("train_step"):
            params, opt_state, _ = step_fn(params, opt_state, b)
        steps += 1
        s += 1
        in_trace += tw_state == 1
    with spans("sync"):
        sync(dev)
    t1 = time.perf_counter()
    if tw is not None:
        if tw_state == 1:
            tw.mark_end()
        tw.close()
    tokens = mix["batch"] * mix["seq_len"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    readings = busy = window = brk = None
    if tw is not None:
        events = tw.events()
        busy = devtrace.busy_seconds(events)
        window = tw.t1 - tw.t0
        brk = devtrace.breakdown(events, spans.items, tw.t0, tw.t1)
        cnt = model.dense_counts(
            ctx.config, params["embed"]["embedding"].shape[0])
        af, ab = cnt.train_attn(mix["batch"], mix["seq_len"])
        readings = {"events": events, "window_s": window, "busy_s": busy,
                    "model_flops": in_trace * cnt.train_flops(
                        mix["batch"], mix["seq_len"]),
                    "attn_flops": in_trace * af, "attn_bytes": in_trace * ab}

    del params, opt_state, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = reference(ctx, cfg, tc, losses, grad_norms, change, moments)
    lim = ctx.limits
    checks = [Check(k, found[k], lim[k])
              for k in ("loss_rel_err", "grad_norm_gap", "change_norm_gap",
                        "mu_rel_err", "nu_rel_err")]
    return Outcome(
        attempted=steps, failed=0,
        e2e={"train_tok_s": e2e.rate(steps * tokens, t1 - t0),
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), readings=readings,
        busy_s=busy, window_s=window, breakdown=brk, extra=found)


def reference(ctx, cfg, tc, losses, grad_norms, change, moments) -> dict:
    """The plain reference's three steps from the same weights and
    batches, and the program's readings held against them (with
    ``ctx.control``, the control's too: the reference in float8)."""
    from repro_torch.models import transformer as T
    heads = model.heads(ctx.config)
    theta = float(ctx.config["rope_theta"])
    opt = opt_dict(tc.opt)
    batches = [batch(ctx, cfg.vocab, s) for s in range(CHECKED_STEPS)]
    runs = [dense.fp32_mm] + ([dense.fp8_mm] if ctx.control else [])
    out, ref, keep = {}, None, None

    def held(l, g, c, m) -> dict:
        return {"loss_rel_err": max(abs(a - b) / abs(b)
                                    for a, b in zip(l, ref["losses"])),
                "grad_norm_gap": compare.worst_leaf_gap(
                    g, ref["grad_norms"]),
                "change_norm_gap": compare.worst_leaf_gap(
                    c, ref["change_norms"], keep),
                **{f"{k}_rel_err": compare.worst_leaf_rel_err(
                    m[k], ref[k], keep) for k in ("mu", "nu")}}
    with dense.strict_fp32():
        for mm in runs:
            params = weights.make(T.model_defs(cfg), ctx.seed, ctx.device)
            r = dense.train(params, batches, heads, theta, opt, mm)
            del params
            gc.collect()
            if ref is None:
                ref = r
                keep = compare.moving_leaves(ref["grad_norms"])
                out = held(losses, grad_norms, change, moments)
                if ctx.control:     # room on the card for the control's
                    for k in ("mu", "nu"):
                        ref[k] = [t.to("cpu") for t in ref[k]]
            else:
                out.update({f"{k}_control": v for k, v in held(
                    r["losses"], r["grad_norms"], r["change_norms"],
                    r).items()})
            del r
    out["losses"], out["ref_losses"] = losses, ref["losses"]
    out["left_out_leaves"] = keep.count(False)
    return out
