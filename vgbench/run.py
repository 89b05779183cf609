"""Run one cell of the benchmark once; see vgbench/harness.py.

    python3 vgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from vgbench.harness import main

    sys.exit(main(sys.argv[1:], T_START, ROOT))
