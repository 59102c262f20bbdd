#!/usr/bin/env python3
"""SASS of B7 windowed's field inversion in the two builds that
tools/b7_lane_check.py tells apart.

corda_tpu_torch/csrc/ed25519_windowed.cu's pair kernel inverts the ladder's
Z on both lanes (``fe_inv`` of csrc/field25519_comba.cuh, ``__noinline__``:
a function of its own in the SASS) and then forms the affine x and y.
Built as it is, both lanes agree on zi; built with
``-DED25519_WINDOWED_PAIR_AFFINE`` (X zi and Y zi one a lane by
``pair_mul``), the lanes hold the same point but a different zi. This script
compiles the file to a cubin both ways with the library's nvcc flags,
disassembles each with ``cuobjdump -sass``, and prints a JSON line a build
(the SASS functions, each one's instruction count, the opcode histogram of
``fe_inv``) and one comparing them: whether each ``fe_inv`` function is
the same instruction for instruction (addresses and encodings dropped),
where they first differ, and the instructions around the pair kernel's
calls of it. The full listings go to ``--out`` (default fe_inv_sass/ in
the working directory).

    python3 tools/fe_inv_sass.py [--out DIR]

It needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDS = {"as_is": [], "pair_affine": ["-DED25519_WINDOWED_PAIR_AFFINE"]}
#: Instructions shown on each side of a call of fe_inv.
CONTEXT = 24

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def functions(sass: str) -> dict:
    """{function name: [instruction text, ...]} of a cuobjdump listing,
    addresses, encodings and trailing comments dropped."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            out[name].append(" ".join(m.group(1).split()))
    return out


def opcodes(insns: list) -> dict:
    hist = collections.Counter()
    for insn in insns:
        words = insn.split()
        op = words[1] if words[0].startswith("@") and len(words) > 1 \
            else words[0]
        hist[op.split(".")[0]] += 1
    return dict(sorted(hist.items()))


def call_sites(insns: list) -> list:
    """The instructions around each CALL (the listing names a call's
    target by its relocation or address; fe_inv is the kernel's one
    noinline callee)."""
    return [insns[max(0, k - CONTEXT):k + CONTEXT + 1]
            for k, insn in enumerate(insns) if "CALL" in insn.split()[0]
            or (insn.startswith("@") and "CALL" in insn)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="fe_inv_sass",
                    help="directory of the two SASS listings")
    out_dir = ap.parse_args().out
    sys.path.insert(0, REPO)
    from corda_tpu_torch import _build
    nvcc = _build.nvcc_path()
    cuobjdump = shutil.which("cuobjdump") or (
        os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None)
    if nvcc is None or cuobjdump is None or not os.path.exists(cuobjdump):
        print("fe_inv_sass: nvcc and cuobjdump are needed", file=sys.stderr)
        return 2
    flags = [f for f in _build._NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, "ed25519_windowed.cu")
    listings = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in BUILDS.items():
            cubin = os.path.join(tmp, f"{name}.cubin")
            build = subprocess.run(
                [nvcc, *flags, *extra, "-cubin", "-o", cubin, src],
                capture_output=True, text=True, timeout=900)
            if build.returncode != 0:
                print(build.stdout + build.stderr, file=sys.stderr)
                return 1
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True, timeout=300).stdout
            with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
                f.write(sass)
            ptxas = [ln.strip() for ln in (build.stdout + build.stderr)
                     .splitlines() if "registers" in ln or "stack" in ln]
            listings[name] = functions(sass)
            fns = listings[name]
            inv = [n for n in fns if "fe_inv" in n]
            print(json.dumps({
                "build": name, "flags": extra, "ptxas": ptxas,
                "functions": {n: len(v) for n, v in fns.items()},
                "fe_inv_opcodes": {n: opcodes(fns[n]) for n in inv}}),
                flush=True)
    a, b = listings["as_is"], listings["pair_affine"]
    compare = {}
    for n in sorted(set(a) | set(b)):
        if "fe_inv" not in n:
            continue
        x, y = a.get(n), b.get(n)
        first = None
        if x is not None and y is not None:
            first = next((k for k, (p, q) in enumerate(zip(x, y)) if p != q),
                         None if len(x) == len(y) else min(len(x), len(y)))
        compare[n] = {"in_as_is": x is not None, "in_pair_affine": y is not None,
                      "identical": x == y, "first_difference": first,
                      "as_is_at": None if first is None else x[first:first + 8],
                      "pair_affine_at": None if first is None
                      else y[first:first + 8]}
    kernels = {}
    for build, fns in listings.items():
        for n, insns in fns.items():
            if "windowed_verify_kernel" in n:
                kernels.setdefault(build, {})[n] = call_sites(insns)
    print(json.dumps({"compare": compare, "call_sites": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
