"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error.  Exits non-zero, with no result, where
there is no CUDA card or too few.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.configure_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
