"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

From the root of a checkout that holds the program under ``src/``.  The
last line of standard output is the result as one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error.  Exits non-zero, printing no result, without enough CUDA
devices or when the program cannot be imported.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
