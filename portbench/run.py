#!/usr/bin/env python3
"""The benchmark of corda_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload ed25519.bulk --seed 7 --seconds 10 \\
        --trace 0

Run from the root of a checkout that holds the port. Prints, as its last
line, one JSON object: correct, attempted, failed, metrics, device (with
--trace 1 also breakdown), and the numbers compared with their limits
under "checks". Exits non-zero, printing no result, where CUDA or the
cell's cards are missing, or the port cannot be imported.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))     # the checkout: the port
sys.path.insert(0, HERE)                      # the harness

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(t_start=T_START))
