#!/usr/bin/env python3
"""Lane agreement of B7 windowed's pair kernel on one NVIDIA GPU.

Each lane of a pair keeps its own copy of the ladder's point, and the even
lane alone stores the verdict, so a divergence between the two copies
would not show in the kernel's output. This script builds
corda_tpu_torch/csrc/ed25519_windowed.cu twice with
``-DED25519_WINDOWED_LANE_CHECK`` (the pair kernel then stores, beside the
even lane's verdict, the odd lane's and whether both lanes hold the same
words of the ladder's point, of zi and of the affine x and y, and keeps
the first 64 items' X, Y, Z, zi, x, y and fe_inv's chain on each lane):
once as it is, once with ``-DED25519_WINDOWED_PAIR_AFFINE`` (X zi and Y zi
one a lane by pair_mul). It runs the pair kernel of each on the
known-answer items and on chip_smoke.py's adversarial B7 batch tiled to
1024, 4097 and 16384 items, and prints a JSON line a build and size:
items, each lane's verdicts equal to the plain version's, the items whose
lanes agree on each value, and (at 1024) the lanes whose zi is Z^(p-2) and
whose every inversion step equals Python's pow. This is chip_smoke.py's
b7_lanes step run alone.

    python3 tools/b7_lane_check.py [--seed N] [--csrc DIR]

``--csrc`` builds another checkout's kernel source (DIR holds
ed25519_windowed.cu and its headers, e.g. ``git archive <commit>
corda_tpu_torch/csrc``); a source without the lane words reports them as
null. It needs CUDA and nvcc, exits non-zero without them, and fails when
either build shows any disagreement.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--csrc", default=None,
                    help="directory of the ed25519_windowed.cu to build "
                         "(default: this checkout's)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b7_lane_check: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from corda_tpu_torch.ops import ed25519 as ed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = cs.start_b7_lane_builds(args.csrc)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        base = cs.make_dataset(pool, args.seed + 37, cs.SIGNERS,
                               cs.B7_DISTINCT)
    items, _ = cs.b7_batch(base, args.seed + 41)
    prep = ed.prepare_batch_windowed(items, device_tables=False)
    dev = torch.device("cuda", 0)
    cases = cs.b7_lane_cases(ed, prep, dev)
    tabs = ed.windowed_table(dev)
    failed = False
    for build, started in builds.items():
        lib = cs.finish_b7_lane_build(build, *started)
        for row in cs.b7_lane_rows(lib, cases, tabs, dev):
            print(json.dumps({"build": build, **row, "card": card}),
                  flush=True)
            failed |= any(row[k] != row["items"] for k in cs.B7_LANE_BITS)
            failed |= any(row.get(k) not in (None, 2 * cs.B7_LANE_ITEMS)
                          for k in ("zi_inverse_lanes", "chain_exact_lanes"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
