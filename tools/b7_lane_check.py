#!/usr/bin/env python3
"""Lane agreement of B7 windowed's pair kernel on one NVIDIA GPU.

Each lane of a pair keeps its own copy of the ladder's point, and the even
lane alone stores the verdict, so a divergence between the two copies
would not show in the kernel's output. This script builds
corda_tpu_torch/csrc/ed25519_windowed.cu twice with
``-DED25519_WINDOWED_LANE_CHECK`` (the pair kernel then stores, beside the
even lane's verdict, the odd lane's and whether both lanes hold the same
words of the ladder's point, of zi and of the affine x and y): once as it
is, once with ``-DED25519_WINDOWED_PAIR_AFFINE`` (X zi and Y zi one a lane
by pair_mul). It runs the pair kernel of each on the known-answer items and
on chip_smoke.py's adversarial B7 batch tiled to 1024, 4097 and 16384
items, and prints a JSON line a build and size: items, each lane's
verdicts equal to the plain version's, and the items whose lanes agree on
each value.

    python3 tools/b7_lane_check.py [--seed N]

It needs CUDA and nvcc, exits non-zero without them, and fails when the
build as it is shows any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDS = {"as_is": ["-DED25519_WINDOWED_LANE_CHECK"],
          "pair_affine": ["-DED25519_WINDOWED_LANE_CHECK",
                          "-DED25519_WINDOWED_PAIR_AFFINE"]}
SIZES = (1024, 4097, 16384)
BITS = {"even_verdict": 0, "odd_verdict": 1, "point": 2, "zi": 3,
        "affine_xy": 4}


def build(flags: list[str], out: str):
    from corda_tpu_torch import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build._NVCC_FLAGS, *flags, "-o", out,
         os.path.join(_build.CSRC, "ed25519_windowed.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def summary(code, want) -> dict:
    """Counts of the diagnostic bits of ``code`` (uint8 numpy) against the
    plain verdicts ``want``."""
    row = {"items": int(code.size)}
    for name, bit in BITS.items():
        b = (code >> bit) & 1
        row[name] = int((b == want).sum() if "verdict" in name else b.sum())
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b7_lane_check: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import known_answers as ka

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "diag")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: (os.path.join(out_dir, f"libed25519_windowed-{name}.so"),
                    build(flags, os.path.join(
                        out_dir, f"libed25519_windowed-{name}.so")))
             for name, flags in BUILDS.items()}

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        base = cs.make_dataset(pool, args.seed + 37, cs.SIGNERS,
                               cs.B7_DISTINCT)
    items, want = cs.b7_batch(base, args.seed + 41)
    name = "ed25519_windowed_verify"
    prep = ed.prepare_batch_windowed(items, device_tables=False)
    *ka_wire, _ = ed.prepare_batch_windowed(list(ka.ed25519_items()),
                                            device_tables=False)
    dev = torch.device("cuda", 0)
    tabs = ed.windowed_table(dev)
    cases = {"known_answers": ka_wire}
    for n in SIZES:
        *wire, _ = cs.take_batch(prep, cs.B7_AXES[name], n)
        cases[str(n)] = wire

    failed = False
    for build_name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"building {build_name} failed:\n{text}")
        lib = ctypes.CDLL(out)
        fn = lib.ed25519_windowed_verify
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        for case, wire in cases.items():
            dargs = ed.b7_to_device(wire, dev)
            plain = ed.verify_core_windowed_plain(*dargs, *tabs)
            n = int(plain.shape[0])
            code = torch.zeros(n, dtype=torch.uint8, device=dev)
            rc = fn(*(t.data_ptr() for t in (*ed.b7_flat(dargs), *tabs)),
                    code.data_ptr(), n, 2,
                    torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"{build_name} launch failed: cudaError {rc}")
            row = summary(code.cpu().numpy(),
                          plain.cpu().numpy().astype("uint8"))
            print(json.dumps({"build": build_name, "case": case, **row,
                              "card": card}), flush=True)
            if build_name == "as_is" and any(
                    v != row["items"] for v in row.values()):
                failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
