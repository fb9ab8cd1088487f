"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size, several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--control] [--fault <name>]

For each seed it runs the cell's driver through a short window and its
check, and prints one JSON line: the program's readings, the control's
with ``--control`` (the reference computed in float8 in the program's
place), and with ``--fault`` the readings of the program with that fault
planted (``portbench/faults.py``).  The benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import faults, harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    mix, config, limits, _ = harness.cell_files(bench, args.workload)
    driver = harness.load_module("drivers", mix["driver"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.Context(args.workload, mix, config, limits, seed,
                              args.seconds, False, dev, t,
                              control=args.control)
        plant = (faults.FAULTS[args.fault]() if args.fault
                 else contextlib.nullcontext())
        with contextlib.redirect_stdout(sys.stderr), plant:
            out = driver.run(ctx)
        row = {"seed": seed, "fault": args.fault, "correct": out.correct,
               "checks": {c.name: c.value for c in out.checks},
               "readings": out.extra, "e2e": out.e2e,
               "attempted": out.attempted, "failed": out.failed,
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    harness.configure_env()
    sys.exit(main(sys.argv[1:]))
