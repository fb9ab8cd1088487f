"""The knee of an open-loop serving cell: the highest arrival rate at
which the backlog does not grow through the window, found once by a
sweep on the card.

    python3 portbench/sweep.py --workload <cell> --rates 2,3,4,5 \\
        --seconds 40 --seed 7

One process sets the cell up once and runs one window at each rate in
turn, each followed to its end.  For each rate it prints one JSON line:
requests, those finished inside the window, the backlog when the window
closed, the time the backlog took to drain, and the median and 90th
percentile of time to first token over the whole window and over its
first and last thirds (a backlog that grows shows as a last third
slower than the first).  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import e2e, harness, traffic  # noqa: E402


def summary(recs, t0: float, seconds: float) -> dict:
    end = t0 + seconds
    ttft = [(r.done - (t0 + r.due)) * 1e3 if r.done else float("inf")
            for r in recs]
    third = [[t for r, t in zip(recs, ttft) if k * seconds / 3 <= r.due
              < (k + 1) * seconds / 3] for k in range(3)]
    done_at = [r.done for r in recs if r.done is not None]
    return {
        "requests": len(recs),
        "done_in_window": sum(1 for r in recs if r.done and r.done <= end),
        "backlog_at_close": sum(1 for r in recs
                                if r.done is None or r.done > end),
        "drain_s": max(0.0, max(done_at, default=end) - end),
        "ttft_p50_ms": e2e.percentile(ttft, 50),
        "ttft_p90_ms": e2e.percentile(ttft, 90),
        "first_third_p50_ms": e2e.percentile(third[0], 50),
        "last_third_p50_ms": e2e.percentile(third[2], 50),
        "mean_prompt": sum(r.n for r in recs) / len(recs)}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    mix, config, limits, _ = harness.cell_files(bench, args.workload)
    driver = harness.load_module("drivers", mix["driver"])
    ctx = harness.Context(args.workload, mix, config, limits, args.seed,
                          args.seconds, False, torch.device("cuda", 0),
                          time.perf_counter())
    st = driver.setup(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        arr = traffic.open_loop(dict(mix, rate_per_s=rate), args.seconds,
                                args.seed, st.cfg.vocab)
        recs, t0, _, _ = driver.serve(st, arr, args.seconds)
        print(json.dumps({"rate_per_s": rate,
                          **summary(recs, t0, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    harness.configure_env()
    sys.exit(main(sys.argv[1:]))
