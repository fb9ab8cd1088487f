"""Per-kernel roofline and energy profiler CLI (the port of
``repro.profile``).

    # profile the serving-scale reduced model on the card
    PYTHONPATH=src python -m repro_torch.profile --smoke

    # on the CPU (the kernels' plain versions: bytes, flops and modeled
    # energy only, every time field null)
    PYTHONPATH=src python -m repro_torch.profile --smoke --device cpu

    # machine-readable roofline + Chrome trace + full metrics snapshot
    PYTHONPATH=src python -m repro_torch.profile --smoke \\
        --json /tmp/roofline.json --trace /tmp/trace.json \\
        --metrics-out /tmp/metrics.json

    # fault injection: corrupt the cached GEMM schedules and watch the
    # model-fidelity gate route them into the miss log for retuning
    # (REPRO_BLOCKED_LINEAR=1: the projections' "matmul" key)
    REPRO_BLOCKED_LINEAR=1 PYTHONPATH=src python -m repro_torch.profile \\
        --no-fuse --prompt-len 48 --corrupt matmul --miss-log /tmp/miss.jsonl
    PYTHONPATH=src python -m repro_torch.tune --from-telemetry \\
        /tmp/miss.jsonl --dry-run

Runs the paged serving engine on JAX's serving-scale reduced model
(d_model 256, 4 layers, 8 query and 4 kv heads, d_ff 1024, vocab 4096),
with a :class:`repro_torch.obs.KernelProfiler` in the ledger slot and a
step tracer always attached (the engines fence every dispatch scope
when a tracer is present, so the scopes' wall clocks include the
device's work).  Every dispatched kernel key gets its calls, the bytes
its grid requests (``hbm_bytes``) and must move (``min_bytes``), its
share of the scopes' time and roofline share against the H100's peaks,
and modeled pJ.  On the card the card's name and power limit print
above the table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

from repro_torch.chaos.inject import CorruptScheduleCache


def card_line() -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.profile",
        description="per-kernel roofline + energy profiler")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized workload (same serving-scale model)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="the model's dtype (JAX's profiler runs float32)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fuse", action="store_true", default=True,
                    help="profile the cross-op fused hot path (default: "
                         "on; its kernels are schedule-driven on every "
                         "call)")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the roofline/energy report as JSON")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="Chrome-trace path (a temp file is used when "
                         "absent: the tracer must be attached so scopes "
                         "are device-fenced)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the full metrics snapshot (registry + "
                         "DRAM + roofline) as JSON")
    ap.add_argument("--miss-log", metavar="PATH", default=None,
                    help="append schedule-cache misses AND fidelity-"
                         "gate hits as JSONL tuning targets for "
                         "python -m repro_torch.tune --from-telemetry")
    ap.add_argument("--fidelity-threshold", type=float, default=0.25,
                    help="resolved/analytic requested-bytes ratio above "
                         "1+threshold sends the op to the miss log")
    ap.add_argument("--corrupt", metavar="OP", default=None,
                    help="fault injection: serve cache hits with "
                         "pessimal tiles for ops whose name contains OP, "
                         "e.g. --corrupt matmul")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.gen = 3, 6
        args.prompt_len, args.max_seq, args.max_batch = 8, 32, 3

    # imports after arg parsing: --help must not pull in the model
    import numpy as np
    import torch

    from repro_torch import tune
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.obs import KernelProfiler, MetricsRegistry, Obs, StepTracer
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    from repro_torch.util import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    prev_cache = None
    if args.corrupt:
        prev_cache = tune.set_default_cache(
            CorruptScheduleCache(args.corrupt))

    # JAX's serving-scale reduced model: per-step work must outweigh the
    # host's dispatch for the roofline to mean anything
    cfg = dataclasses.replace(get_reduced(args.arch),
                              dtype=getattr(torch, args.dtype),
                              d_model=256, n_layers=4, n_heads=8,
                              n_kv_heads=4, d_ff=1024, vocab=4096)
    params = T.init_params(cfg, seed=0, device=device)

    trace_path = args.trace
    if trace_path is None:
        fd, trace_path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
    registry = MetricsRegistry()
    tracer = StepTracer(trace_path)
    profiler = KernelProfiler(
        registry=registry, miss_log=args.miss_log,
        fidelity_threshold=args.fidelity_threshold, tracer=tracer,
        device=device.type)
    obs = Obs(registry=registry, trace=tracer, dram=profiler)

    engine = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=args.max_seq, max_batch=args.max_batch, fuse=args.fuse,
        device=device.type), obs=obs)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (args.prompt_len,),
                            dtype=np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen)
    wall = time.perf_counter() - t0

    rep = profiler.roofline_report()
    print(f"profiled {args.requests} requests x {args.gen} tokens "
          f"on {device.type} in {wall:.2f}s: {len(rep['per_op'])} kernel "
          f"keys, {rep['totals']['dispatches']} dispatches, "
          f"{rep['totals']['hbm_bytes'] / 1e6:.1f} MB requested, "
          f"{rep['totals']['energy_uj']:.1f} uJ modeled "
          f"(traced -> {trace_path})")
    if not profiler.timed:
        print("time, achieved rates and peak_frac: not measured "
              "(plain versions on the CPU)")
    print(profiler.format_roofline())
    if rep["fidelity_misses"]:
        print(f"fidelity gate (>{1 + args.fidelity_threshold:.2f}x the "
              "analytic tiles' requested bytes): "
              + ", ".join(rep["fidelity_misses"]))
        if args.miss_log:
            print(f"  -> appended to {args.miss_log} (replay: "
                  "python -m repro_torch.tune --from-telemetry "
                  f"{args.miss_log})")

    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
            f.write("\n")
        print(f"roofline report -> {args.json}")
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    obs.close()
    if prev_cache is not None:
        tune.set_default_cache(prev_cache)
    assert out.shape[0] == args.requests, out.shape


if __name__ == "__main__":
    main()
