#!/usr/bin/env python3
"""What nvcc makes of B7 windowed's field inversion in the two layouts of
its pair kernel, and of the standalone reproducer of the fault it had.

corda_tpu_torch/csrc/ed25519_windowed.cu's pair kernel inverts the ladder's
Z on both lanes (``fe_inv`` of csrc/field25519_comba.cuh, ``__noinline__``:
a function of its own in the SASS) and then forms the affine x and y, on
both lanes as shipped or one a lane with ``-DED25519_WINDOWED_PAIR_AFFINE``.
While the Comba products' inner loops stayed rolled (their operands in
local memory) and fe_inv wrote its result zi through a reference, nvcc
gave zi, in the ``PAIR_AFFINE`` build, the local-memory slot of the next
product's first operand: the PTX stores that operand over zi after the
call, then reads zi back (ROADMAP §C.1).

This script compiles the file both ways with the library's nvcc flags to
PTX and to a cubin, and prints a JSON line a build: ptxas's report, the
SASS functions and their instruction counts, for the pair kernel's call of
``fe_inv`` by reference the frame offset of its output and whether, after
the call, a store into that slot comes before any load from it
(``"clobbered"``, with the PTX line), and the SASS from the pair kernel's
first CALL to the first reload after the first store. A last line names
the functions the two builds compile identically. The listings go to
``--out`` (default fe_inv_sass/ in the working directory).

    python3 tools/fe_inv_sass.py [--csrc DIR] [--out DIR] [--repro]

``--csrc`` reads another checkout's kernel source (DIR holds
ed25519_windowed.cu and its headers, e.g. ``git archive <commit>
corda_tpu_torch/csrc``). ``--repro`` also builds
corda_tpu_torch/csrc/diag/frame_slot_repro.cu as it is, with
``-DBY_VALUE`` and with ``-DUNROLLED``, checks each one's PTX the same
way and, where a card is present, runs it (exit 1: miscompiled). It needs
nvcc and cuobjdump (the CUDA toolkit).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDS = {"as_is": [], "pair_affine": ["-DED25519_WINDOWED_PAIR_AFFINE"]}
REPRO = {"by_reference": [], "by_value": ["-DBY_VALUE"],
         "unrolled": ["-DUNROLLED"]}
#: SASS instructions shown before a CALL, and at most after it.
CONTEXT = 8
AFTER = 40

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_ADDR = re.compile(r"(?:add|sub)\.[us]64\s+(%rd\d+),\s*(%SPL|%SP|%rd\d+),"
                   r"\s*(-?\d+);")
_MOVA = re.compile(r"mov\.u64\s+(%rd\d+),\s*(%SPL|%SP|%rd\d+);")
_STL = re.compile(r"st\.local\.[a-z0-9.]+\s+\[(%rd\d+)(?:\+(-?\d+))?\]")
_LDL = re.compile(r"ld\.local\.[a-z0-9.]+\s+%\w+,\s*\[(%rd\d+)"
                  r"(?:\+(-?\d+))?\]")
_PARAM0 = re.compile(r"st\.param\.b64\s+\[param0\+0\],\s*(%rd\d+)")
#: PTX lines scanned after a call for the first access to its output slot.
SCAN = 400


def functions(sass: str) -> dict:
    """{function name: [(address, instruction text), ...]} of a cuobjdump
    listing, encodings and trailing comments dropped."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16),
                              " ".join(m.group(2).split())))
    return out


def output_slots(ptx: str) -> list:
    """For each call in ``ptx`` whose first argument is a frame address
    (``%SP`` plus a constant): the callee, the slot's offset, and the
    first access to the slot's 32 bytes in the next SCAN lines, a load
    ("read first") or a store ("clobbered", with its line)."""
    rows = []
    for fn in re.split(r"\n(?=\.(?:visible )?\.?(?:func|entry))", ptx):
        off = {"%SP": 0, "%SPL": 0}
        for m in _ADDR.finditer(fn):
            if m.group(2) in off:
                sign = -1 if m.group(0).startswith("sub") else 1
                off[m.group(1)] = off[m.group(2)] + sign * int(m.group(3))
        for m in _MOVA.finditer(fn):
            if m.group(2) in off:
                off[m.group(1)] = off[m.group(2)]
        lines = fn.splitlines()
        for k, line in enumerate(lines):
            if "call.uni" not in line or k + 1 >= len(lines):
                continue
            slot = next((off.get(m.group(1)) for j in range(k - 1,
                         max(0, k - 40), -1)
                         for m in [_PARAM0.search(lines[j])] if m), None)
            if slot is None:
                continue
            row = {"callee": lines[k + 1].strip().rstrip(","),
                   "slot": slot, "first_access": "none"}
            for after in lines[k + 1:k + SCAN]:
                for pat, what in ((_STL, "clobbered"), (_LDL, "read first")):
                    m = pat.search(after)
                    if m and m.group(1) in off and \
                            slot <= off[m.group(1)] + int(m.group(2) or 0) \
                            < slot + 32:
                        row["first_access"] = what
                        if what == "clobbered":
                            row["ptx"] = after.strip()
                        break
                if row["first_access"] != "none":
                    break
            rows.append(row)
    return rows


def after_call(insns: list, callee: int) -> list:
    """The SASS from CONTEXT instructions before each CALL of the function
    at address ``callee`` to the first LDL after the first STL after it
    (at most AFTER)."""
    out = []
    for k, (_, insn) in enumerate(insns):
        if "CALL" in insn and hex(callee) in insn:
            tail, stored = [], False
            for _, nxt in insns[k + 1:k + 1 + AFTER]:
                tail.append(nxt)
                stored |= nxt.split()[0].startswith("STL")
                if stored and nxt.split()[0].startswith("LDL"):
                    break
            out.append([i for _, i in insns[max(0, k - CONTEXT):k + 1]]
                       + tail)
    return out


def compile_both(nvcc, flags, extra, src, out_base):
    """(PTX text, cubin path, nvcc's output) of ``src`` under ``extra``."""
    ptx, cubin = out_base + ".ptx", out_base + ".cubin"
    logs = []
    for kind, out in (("-ptx", ptx), ("-cubin", cubin)):
        r = subprocess.run([nvcc, *flags, *extra, kind, "-o", out, src],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(r.stdout + r.stderr)
        logs.append(r.stdout + r.stderr)
    with open(ptx) as f:
        return f.read(), cubin, "\n".join(logs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="fe_inv_sass",
                    help="directory of the listings")
    ap.add_argument("--csrc", default=None,
                    help="directory of the ed25519_windowed.cu to compile "
                         "(default: this checkout's)")
    ap.add_argument("--repro", action="store_true",
                    help="also build, check and run frame_slot_repro.cu")
    args = ap.parse_args()
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
    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(args.csrc or _build.CSRC, "ed25519_windowed.cu")
    listings = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in BUILDS.items():
            ptx, cubin, log = compile_both(nvcc, flags, extra, src,
                                           os.path.join(tmp, name))
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True, timeout=300).stdout
            for ext, text in (("sass", sass), ("ptx", ptx)):
                with open(os.path.join(args.out, f"{name}.{ext}"), "w") as f:
                    f.write(text)
            fns = listings[name] = functions(sass)
            pair = next(v for n, v in fns.items()
                        if n.startswith("_ZN5pairs")
                        and "windowed_verify_kernel" in n)
            calls = [int(m.group(1), 16) for _, i in pair
                     for m in [re.search(r"CALL\S*\s+0x([0-9a-f]+)", i)]
                     if m]
            slots = [r for r in output_slots(ptx) if "pairs" in r["callee"]
                     and "fe_inv" in r["callee"]]
            print(json.dumps({
                "build": name, "source": src, "flags": extra,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "stack" in ln],
                "functions": {n: len(v) for n, v in fns.items()},
                "pair_kernel_fe_inv_output": slots,
                "sass_at_first_call": after_call(pair, calls[0])[:1]
                if calls else []}), flush=True)
        if args.repro:
            repro(nvcc, flags, tmp, args.out)
    a, b = listings["as_is"], listings["pair_affine"]
    print(json.dumps({"identical_functions": sorted(
        n for n in set(a) & set(b) if a[n] == b[n])}), flush=True)
    return 0


def repro(nvcc, flags, tmp, out_dir):
    """frame_slot_repro.cu in each REPRO form: its calls' output slots in
    the PTX, and its run on the card where there is one."""
    src = os.path.join(REPO, "corda_tpu_torch", "csrc", "diag",
                       "frame_slot_repro.cu")
    import torch
    for name, extra in REPRO.items():
        ptx, _, _ = compile_both(nvcc, flags, extra, src,
                                 os.path.join(tmp, f"repro_{name}"))
        with open(os.path.join(out_dir, f"repro_{name}.ptx"), "w") as f:
            f.write(ptx)
        exe = os.path.join(tmp, f"repro_{name}")
        subprocess.run([nvcc, *flags, *extra, "-o", exe, src], check=True,
                       capture_output=True, timeout=900)
        ran = None
        if torch.cuda.is_available():
            r = subprocess.run([exe], capture_output=True, text=True,
                               timeout=300)
            ran = {"exit": r.returncode, "stdout": r.stdout.strip()}
        print(json.dumps({"repro": name, "flags": extra,
                          "outputs": output_slots(ptx), "run": ran}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
