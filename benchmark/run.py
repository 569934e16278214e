"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 benchmark/run.py --workload gpt2s-ilql-train --seed 1 --seconds 40 --trace 0

Run from the root of a checkout of the repository; it needs a CUDA device
(see `benchmark/harness.py`).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
