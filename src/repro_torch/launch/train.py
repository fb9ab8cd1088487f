"""Training launcher of the port.

    python -m repro_torch.launch.train --arch granite-3-8b --steps 100 \
        --reduced --ckpt-dir /tmp/ckpt --restore auto

Run alone it is a one-rank world on one device: the card by default,
``--device cpu`` for the plain PyTorch versions of the kernels (use
``--reduced`` there).  Under ``torchrun`` (``python -m
torch.distributed.run --nproc-per-node N -m repro_torch.launch.train
...``) every rank joins the process group from the environment (NCCL
on the card, one card a rank; gloo with ``--device cpu``) and trains on
JAX's host mesh -- a data-only mesh over the world, mapping ``{"data":
("data",), "model": None}`` -- through the sharded route
(``models/spmd.py``): each rank keeps its FSDP shards and its rows of
every batch, and rank 0 prints and writes the files.
``--production-mesh`` takes the (16, 16) mesh and JAX's mapping with
tensor parallelism; it needs 256 ranks and raises with fewer.  Weights are
random, drawn from ``--seed``; batches come from the seekable synthetic
pipeline, so ``--restore auto`` resumes from the newest valid checkpoint
on the same trajectory.  ``--blocked-kernels`` runs every projection
through the blocked GEMM and its dgrad kernels (forward and backward);
attention runs the flash-attention kernels forward and backward on the
card either way.  The flags are JAX's launcher's, plus ``--device``,
``--dtype`` and ``--seed``: ``--metrics-out`` writes the train gauges
and the DRAM report, ``--trace`` a Chrome-trace timeline of every step
and ``--miss-log`` the schedule-cache misses (meaningful with
``--blocked-kernels``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.obs import Obs, format_metrics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train

PRODUCTION_RANKS = 256


def _join_world(device: str) -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (True), or stay a one-rank world (False)."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="env://")
    return True


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
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics snapshot (train gauges + "
                         "modeled-vs-resolved DRAM report) as JSON")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace span timeline of every "
                         "train step (step/grad/fwd_bwd/optimizer/"
                         "checkpoint spans + loss/throughput counter "
                         "tracks); fences the device after each span")
    ap.add_argument("--miss-log", metavar="PATH", default=None,
                    help="append schedule-cache misses as JSONL tuning "
                         "targets (meaningful with --blocked-kernels)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.production_mesh and world != PRODUCTION_RANKS:
        raise RuntimeError(f"--production-mesh needs {PRODUCTION_RANKS} "
                           f"ranks (a 16x16 mesh); this world has {world}")
    joined = _join_world(args.device)
    try:
        _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args) -> None:
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    mesh = mapping = None
    rank, rows = 0, slice(None)
    if dist.is_initialized():
        mesh = (make_production_mesh(device=args.device)
                if args.production_mesh else make_host_mesh(args.device))
        mapping = ({"data": ("data",), "model": "model"}
                   if "model" in mesh.mesh_dim_names else
                   {"data": ("data",), "model": None})
        rank = dist.get_rank()
        n = mesh.get_group("data").size()
        if args.batch % n:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{n} data ranks")
        i = mesh.get_local_rank("data")
        rows = slice(i * args.batch // n, (i + 1) * args.batch // n)
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
            batch = make_batch(cfg, args.seq_len, args.batch, step,
                               device=args.device)
            yield {k: v[rows] for k, v in batch.items()}

    if rank:                      # rank 0 prints and writes the files
        train(cfg, tc, batches(), seed=args.seed,
                       device=args.device, restore=args.restore == "auto",
                       obs=Obs(), log=lambda *a: None, mesh=mesh,
                       mapping=mapping)
        return
    # closed on any exit, so an interrupted run keeps its trace so far
    with Obs(trace=args.trace, miss_log=args.miss_log) as obs:
        result = train(cfg, tc, batches(), seed=args.seed,
                       device=args.device, restore=args.restore == "auto",
                       obs=obs, mesh=mesh, mapping=mapping)
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


if __name__ == "__main__":
    main()
