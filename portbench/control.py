#!/usr/bin/env python3
"""The control of a cell: the reference with one guarantee broken, judged
on the cell's inputs as a run judges the program. Not part of a benchmark
run; its readings set the upper end of each limit (PERF.md).

    python3 portbench/control.py --workload ed25519.bulk --seeds 11 12 13
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from harness import control  # noqa: E402

if __name__ == "__main__":
    sys.exit(control.main())
