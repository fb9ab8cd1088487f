"""Chaos harness CLI (the port of ``python -m repro.chaos``).

    # fast lane: one seeded real-engine schedule (on the card unless
    # --device cpu) + 8 scheduler-level schedules
    PYTHONPATH=src python -m repro_torch.chaos --smoke [--device cpu]

    # acceptance bar: 200 randomized scheduler-level fault schedules
    PYTHONPATH=src python -m repro_torch.chaos --schedules 200

Every schedule asserts the serving invariants in-line (an assertion
failure is the report); the CLI's own output just proves the schedules
were not vacuously clean — how many faults of each kind were injected.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving chaos/fault-injection harness")
    ap.add_argument("--smoke", action="store_true",
                    help="seeded engine schedule + 8 sim schedules "
                         "(the CI fast-lane entry)")
    ap.add_argument("--schedules", type=int, default=None, metavar="N",
                    help="run N randomized scheduler-level fault "
                         "schedules (acceptance bar: 200)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --smoke's engine schedule runs")
    args = ap.parse_args(argv)
    if not args.smoke and args.schedules is None:
        args.schedules = 200

    from repro_torch.chaos.runner import engine_smoke, run_schedules

    if args.smoke:
        res = engine_smoke(seed=args.seed, device=args.device)
        print(f"engine smoke: drained in {res['steps']} steps, "
              f"nan_guard trips={res['nan_trips']}, zero leaked pages")
        for rid, status in sorted(res["statuses"].items()):
            print(f"  rid {rid}: {status}")
        stats = run_schedules(8, seed=args.seed)
    else:
        stats = run_schedules(args.schedules, seed=args.seed)

    n = stats.pop("schedules")
    print(f"{n} randomized fault schedules passed "
          f"(zero page leaks, all requests terminal, "
          f"survivors byte-exact):")
    for k in sorted(stats):
        print(f"  {k:>14}: {stats[k]}")
    print("CHAOS PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
