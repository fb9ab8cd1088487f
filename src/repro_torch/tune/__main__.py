"""Offline schedule tuning CLI: pre-populate the port's schedule cache.

    PYTHONPATH=src python -m repro_torch.tune matmul 8 4096 4096 \\
        --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.tune matmul_dgrad 2048 4096 12800 \\
        --dtype bfloat16 --no-measure
    PYTHONPATH=src python -m repro_torch.tune flash_decode 4 512 128 \\
        --dtype bfloat16 --no-measure
    PYTHONPATH=src python -m repro_torch.tune qkv_fused 8 1024 4096 4 \\
        --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.tune matmul_w8 8 4096 4096 \\
        --dtype bfloat16 --no-measure
    PYTHONPATH=src python -m repro_torch.tune flash_decode_fp8 4 512 128 \\
        --dtype bfloat16 --no-measure
    PYTHONPATH=src python -m repro_torch.tune conv2d 56 56 128 256 3 3 \\
        --dtype bfloat16 --stride 1
    PYTHONPATH=src python -m repro_torch.tune --from-telemetry miss.jsonl \\
        --dry-run

Prints the analytic candidate table, times the top-N on the card (unless
``--no-measure``; without a CUDA device measuring raises) and persists
the winner.  ``kernels.ops`` and the paged engine read the *default*
cache (``$REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_torch/schedules.json``); when tuning into a ``--cache``
override, point ``REPRO_TORCH_TUNE_CACHE`` at that file at run time.

``--from-telemetry LOG`` replays a miss log (the JSONL file a
``repro_torch.obs.DramLedger`` writes for every schedule-cache miss and
every fidelity-gate hit) as tuning targets: each distinct (op, dims,
dtype, stride) is tuned and persisted.  With ``--dry-run`` the targets
are listed and validated (an unknown op or a wrong dim count raises) but
nothing is measured or persisted.
"""

from __future__ import annotations

import argparse

from repro_torch.tune import (OpSpec, ScheduleCache, describe_candidates,
                              device_kind, tune_op)
from repro_torch.tune.schedule import OPS


def _tune_one(spec: OpSpec, args, cache: ScheduleCache) -> None:
    print(f"tuning {spec.key(device_kind())}")
    print(describe_candidates(spec))
    winner = tune_op(spec.op, spec.dims, spec.dtype, top_n=args.top_n,
                     measure=not args.no_measure, cache=cache,
                     stride=spec.stride)
    extra = (f"  {winner.measured_us:.1f} us/call"
             if winner.measured_us is not None else "")
    print(f"winner: tiles={winner.tiles} ({winner.source}){extra}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("op", choices=OPS, nargs="?",
                    help="op to tune (omit with --from-telemetry)")
    ap.add_argument("dims", type=int, nargs="*",
                    help="matmul, matmul_fused, matmul_w8, "
                         "matmul_fused_w8: M N K; "
                         "matmul_dgrad: the cotangent's M_out N_out "
                         "K_reduce (dA: M K N; dB: K N M); "
                         "flash_decode, flash_decode_fp8: G S D (GQA "
                         "group size, max KV length, head dim); "
                         "qkv_fused: M Nkv K G (Nkv the k/v projection "
                         "width); flash_decode_oproj: G S D E (E = "
                         "d_model); conv2d, conv2d_dgrad, conv2d_wgrad: "
                         "X Y C K Fw Fh in the nest's output space (dgrad: "
                         "the transposed conv's, channels swapped)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the activations' dtype (the quantized keys' "
                         "weights or pages are one byte whatever it is)")
    ap.add_argument("--stride", type=int, default=1,
                    help="the conv keys' stride (conv2d_dgrad: 1)")
    ap.add_argument("--top-n", type=int, default=3,
                    help="how many candidates to time")
    ap.add_argument("--no-measure", action="store_true",
                    help="persist the analytic winner without timing")
    ap.add_argument("--cache", default=None,
                    help="schedule cache path (default: "
                         "$REPRO_TORCH_TUNE_CACHE or ~/.cache/repro_torch)")
    ap.add_argument("--from-telemetry", metavar="LOG", default=None,
                    help="replay a miss log (JSONL, one schedule-cache "
                         "miss or fidelity-gate hit a line) as tuning "
                         "targets")
    ap.add_argument("--dry-run", action="store_true",
                    help="with --from-telemetry: list and validate the "
                         "targets without measuring or persisting")
    args = ap.parse_args(argv)

    cache = ScheduleCache(args.cache)
    if args.from_telemetry is not None:
        from repro_torch.obs.dram import read_miss_log
        targets = read_miss_log(args.from_telemetry)
        print(f"{len(targets)} distinct miss target(s) in "
              f"{args.from_telemetry}")
        for t in targets:
            spec = OpSpec(t["op"], tuple(t["dims"]), t["dtype"],
                          t["stride"])
            if args.dry_run:
                print(f"  would tune {spec.key(device_kind())}")
                continue
            _tune_one(spec, args, cache)
        if not args.dry_run and targets:
            print(f"persisted to {cache.path}")
        return

    if args.op is None or not args.dims:
        ap.error("op and dims are required (or use --from-telemetry LOG)")
    spec = OpSpec(args.op, tuple(args.dims), args.dtype, args.stride)
    _tune_one(spec, args, cache)
    print(f"persisted to {cache.path}")


if __name__ == "__main__":
    main()
