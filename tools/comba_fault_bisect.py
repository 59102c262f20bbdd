#!/usr/bin/env python3
"""The Comba field's lane fault (ROADMAP §C.1), rebuilt and bisected on one
NVIDIA GPU from this checkout's sources.

B7 windowed's pair kernel built with ``-DED25519_WINDOWED_PAIR_AFFINE`` (X zi
and Y zi one a lane) gave wrong verdicts while two things held: the Comba
products' inner loops had bounds that depend on the column (nvcc left them
rolled, so their operands lived in local memory), and ``fe_inv`` wrote its
result through a reference. The repair in csrc/ undid both. This script
copies csrc/ to a temporary directory once per variant, puts back one or
both ingredients and, on the copy that has both, each change tried while
the cause was unknown, then builds the pair kernel with
``-DED25519_WINDOWED_LANE_CHECK -DED25519_WINDOWED_PAIR_AFFINE`` and runs it
on the known answers and chip_smoke.py's adversarial B7 batch at 1024, 4097
and 16384 items (chip_smoke.py's b7_lanes rows). One JSON line a variant
and case: the items, each lane's verdicts equal to the plain version's, the
items whose lanes agree on the point, zi and affine x, y, and at 1024, over
the first 64 items, the lanes whose zi is Z^(p-2), whose every step of
fe_inv's chain equals Python's pow, and whose zi is the operand pair_mul
picks after the call (X on the even lane, Y on the odd one).

    python3 tools/comba_fault_bisect.py [--seed N] [--only NAMES]

It needs CUDA and nvcc and exits non-zero without them, or when a variant's
source cannot be rewritten; wrong verdicts are its output, not a failure.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD, CARRY, KERNEL = ("field25519_comba.cuh", "carry.cuh",
                        "ed25519_windowed.cu")
FLAGS = ["-DED25519_WINDOWED_LANE_CHECK", "-DED25519_WINDOWED_PAIR_AFFINE"]


def edit(d: str, name: str, old: str, new: str, regex: bool = False):
    path = os.path.join(d, name)
    with open(path) as f:
        text = f.read()
    out = re.sub(old, new, text) if regex else text.replace(old, new)
    if out == text:
        raise SystemExit(f"comba_fault_bisect: no {old!r} in {name}")
    with open(path, "w") as f:
        f.write(out)


def rolled(d: str):
    """The Comba inner loops over bounds that depend on the column."""
    edit(d, CARRY, "for (int i = 0; i < 8; ++i)\n"
         "      if (k - i >= 0 && k - i < 8) mac3",
         "for (int i = (k < 8 ? 0 : k - 7); i <= (k < 8 ? k : 7); ++i)\n"
         "      mac3")
    edit(d, CARRY, "for (int i = 0; i < 8; ++i)\n"
         "      if (k - i < 8 && 2 * i < k) mac3",
         "for (int i = (k < 8 ? 0 : k - 7); 2 * i < k; ++i)\n      mac3")


def by_reference(d: str):
    """fe_sqr_n and fe_inv writing their results through references."""
    edit(d, FIELD, "fe fe_sqr_n(fe a, int n) {\n#pragma unroll 1\n"
         "  for (int i = 0; i < n; ++i) fe_sqr(a, a);\n  return a;\n}",
         "void fe_sqr_n(fe &o, const fe &a, int n) {\n  o = a;\n"
         "#pragma unroll 1\n  for (int i = 0; i < n; ++i) fe_sqr(o, o);\n}")
    edit(d, FIELD, r"t = fe_sqr_n\((\w+), ", r"fe_sqr_n(t, \1, ", regex=True)
    edit(d, FIELD, "fe fe_inv(fe a) {", "void fe_inv(fe &o, const fe &a) {")
    edit(d, FIELD, "z_100_0, o;", "z_100_0;")
    edit(d, FIELD, "  return o;\n}", "}")
    edit(d, KERNEL, "const fe zi = fe_inv(acc.Z);\n  fe x, y, r;",
         "fe zi, x, y, r;\n  fe_inv(zi, acc.Z);")


def inline(fn: str):
    return lambda d: edit(d, FIELD, rf"__noinline__ (\w+) {fn}\(",
                          rf"__forceinline__ \1 {fn}(", regex=True)


def launch_bounds_2(d: str):
    edit(d, KERNEL, "__launch_bounds__(kBlock, 4)", "__launch_bounds__(kBlock, 2)")


def portable_carries(d: str):
    edit(d, CARRY, "#ifdef __CUDACC__\n", "#if 0\n")


def syncwarp(d: str):
    edit(d, KERNEL, "  fe_inv(zi, acc.Z);\n",
         "  __syncwarp();\n  fe_inv(zi, acc.Z);\n  __syncwarp();\n")


#: name: (source edits in order, extra nvcc flags). "faulty" puts back both
#: ingredients; the variants after it each change one thing on top of it.
FAULTY = [rolled, by_reference]
VARIANTS = {
    "repaired": ([], []),
    "rolled_only": ([rolled], []),
    "by_reference_only": ([by_reference], []),
    "faulty": (FAULTY, []),
    "faulty_fe_inv_inline": (FAULTY + [inline("fe_inv")], []),
    "faulty_fe_sqr_n_inline": (FAULTY + [inline("fe_sqr_n")], []),
    "faulty_ptxas_O1": (FAULTY, ["-Xptxas", "-O1"]),
    "faulty_ptxas_O2": (FAULTY, ["-Xptxas", "-O2"]),
    "faulty_launch_bounds_2": (FAULTY + [launch_bounds_2], []),
    "faulty_portable_carries": (FAULTY + [portable_carries], []),
    "faulty_syncwarp": (FAULTY + [syncwarp], []),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all)")
    args = ap.parse_args()
    names = list(VARIANTS) if args.only is None else args.only.split(",")
    import torch
    if not torch.cuda.is_available():
        print("comba_fault_bisect: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ed
    nvcc = _build.nvcc_path()
    if nvcc is None:
        print("comba_fault_bisect: no nvcc", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="comba_fault_")
    started = {}
    for name in names:
        edits, extra = VARIANTS[name]
        d = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, d)
        for fn in edits:
            fn(d)
        out = os.path.join(tmp, f"lib{name}.so")
        started[name] = (out, out, subprocess.Popen(
            [nvcc, *_build._NVCC_FLAGS, *FLAGS, *extra, "-o", out,
             os.path.join(d, KERNEL)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    try:
        for name, build in started.items():
            lib = cs.finish_b7_lane_build(name, *build)
            for row in cs.b7_lane_rows(lib, cases, tabs, dev):
                print(json.dumps({"variant": name, **row, "card": card}),
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
