"""Training launcher of the port.

    python -m repro_torch.launch.train --arch granite-3-8b --steps 100 \
        --reduced --ckpt-dir /tmp/ckpt --restore auto

Runs on one device: the card by default, ``--device cpu`` for the plain
PyTorch versions of the kernels (use ``--reduced`` there).  Weights are
random, drawn from ``--seed``; batches come from the seekable synthetic
pipeline, so ``--restore auto`` resumes from the newest valid checkpoint
on the same trajectory.  ``--blocked-kernels`` runs every projection
through the blocked GEMM and its dgrad kernels (forward and backward);
attention runs the flash-attention kernels forward and backward on the
card either way.  The flags are JAX's launcher's, plus ``--device``,
``--dtype`` and ``--seed``: ``--metrics-out`` writes the train gauges
and the DRAM report, ``--trace`` a Chrome-trace timeline of every step
and ``--miss-log`` the schedule-cache misses (meaningful with
``--blocked-kernels``).  Not ported yet, and refused when given:
``--production-mesh`` (distribution, ``ROADMAP.md`` queue 1, item 16).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.obs import Obs, format_metrics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--blocked-kernels", action="store_true",
                    help="route projections through the blocked GEMM "
                         "kernel and its dgrad kernels (tiles from the "
                         "blocking model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", choices=["auto", "none"], default="none")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh (not ported: ROADMAP.md, queue 1, "
                         "item 16)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics snapshot (train gauges + "
                         "modeled-vs-resolved DRAM report) as JSON")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace span timeline of every "
                         "train step (step/grad/checkpoint spans + "
                         "loss/throughput counter tracks)")
    ap.add_argument("--miss-log", metavar="PATH", default=None,
                    help="append schedule-cache misses as JSONL tuning "
                         "targets (meaningful with --blocked-kernels)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: distribution is not ported yet; see "
            "ROADMAP.md, queue 1, item 16")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        blocked_linear=args.blocked_kernels,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)

    def batches():
        for step in range(args.steps):
            yield make_batch(cfg, args.seq_len, args.batch, step,
                             device=args.device)

    obs = Obs(trace=args.trace, miss_log=args.miss_log)
    result = train(cfg, tc, batches(), seed=args.seed, device=args.device,
                   restore=args.restore == "auto", obs=obs)
    print(f"final loss: {result['history'][-1]:.4f} "
          f"(start {result['history'][0]:.4f})")
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
        print(format_metrics({"train": obs.snapshot().get("train", {})}))
    if args.trace:
        print(f"chrome trace -> {args.trace}")
    if args.miss_log:
        print(f"schedule-cache miss log -> {args.miss_log} (replay: "
              "python -m repro_torch.tune --from-telemetry)")
    obs.close()


if __name__ == "__main__":
    main()
