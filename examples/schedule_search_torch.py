"""Schedule search on the PyTorch/CUDA port, two ways.

Default (the paper's co-design study): sweep the SRAM budget on one
layer, watch the optimal hierarchy and blocking change, and print the
energy/area Pareto (paper Fig. 7 methodology).  Touches no device.

    PYTHONPATH=src python examples/schedule_search_torch.py [--layer Conv4]

``--hopper``: run the same analytical model through the port's schedule
autotuner instead -- lower the layer to the CUDA kernels' tile
candidates on the H100 target, rank them by predicted DRAM traffic,
optionally time the top few on the card (``--measure``; raises without
a CUDA device), and persist the winner in the schedule cache that
``repro_torch.kernels.ops`` consults by default (``--cache PATH`` writes
another file; point ``REPRO_TORCH_TUNE_CACHE`` at it at run time):

    PYTHONPATH=src python examples/schedule_search_torch.py --layer Conv4 \\
        --hopper --measure
"""

import argparse

from repro_torch.configs import PAPER_LAYERS
from repro_torch.core import make_objective, optimize_beam


def codesign_sweep(args) -> None:
    p = PAPER_LAYERS[args.layer]
    print(f"{args.layer}: {p.macs/1e9:.2f} GMACs")
    print(f"{'budget':>8s} {'pJ/MAC':>8s} {'area mm2':>9s}  schedule")
    for budget_kb in (64, 256, 1024, 8192):
        obj = make_objective("custom",
                             sram_budget_bytes=budget_kb * 1024)
        best = optimize_beam(p, obj, n_levels=args.levels, beam=8,
                             perturbations=3)[0]
        r = best.report
        print(f"{budget_kb:6d}KB {r.pj_per_mac:8.3f} {r.area_mm2:9.2f}  "
              f"{best.string}")


def hopper_tune(args) -> None:
    from repro_torch.tune import (OpSpec, ScheduleCache,
                                  describe_candidates, tune_op)

    p = PAPER_LAYERS[args.layer]
    if p.Fw == 1 and p.Fh == 1 and p.Y == 1:    # FC layer -> GEMM
        spec = OpSpec("matmul", (p.X * p.N, p.K, p.C), args.dtype)
    else:
        spec = OpSpec("conv2d", (p.X, p.Y, p.C, p.K, p.Fw, p.Fh),
                      args.dtype)
    print(f"{args.layer} as {spec.op}{spec.dims}: lowering the analytical "
          "winners to H100 CUDA kernel tiles")
    print(describe_candidates(spec))

    cache = ScheduleCache(args.cache) if args.cache else None
    winner = tune_op(spec.op, spec.dims, spec.dtype,
                     measure=args.measure, cache=cache)
    extra = (f", {winner.measured_us:.0f} us/call measured"
             if winner.measured_us is not None else "")
    print(f"\nwinner ({winner.source}{extra}): tiles={winner.tiles}")
    if args.cache:
        print(f"persisted to {args.cache}; point REPRO_TORCH_TUNE_CACHE "
              "at it so repro_torch.kernels.ops picks it up")
    else:
        print("persisted: repro_torch.kernels.ops will use these tiles "
              "for this shape from now on")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layer", default="Conv4", choices=PAPER_LAYERS)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--hopper", action="store_true",
                    help="lower to the CUDA kernels' tiles via the "
                         "autotuner")
    ap.add_argument("--measure", action="store_true",
                    help="with --hopper: time the top candidates on the "
                         "card")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--cache", default=None,
                    help="with --hopper: schedule-cache path override")
    args = ap.parse_args()
    if args.hopper:
        hopper_tune(args)
    else:
        codesign_sweep(args)


if __name__ == "__main__":
    main()
