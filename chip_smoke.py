#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch on one NVIDIA GPU: builds every kernel of the
port from the sources in this checkout, holds each against its plain PyTorch
version, and drives the Ed25519 verification service path end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. probe   — card name and power limit (nvidia-smi), torch/CUDA versions,
             parallel build of the CUDA kernel library and libscalarmath
             (seconds, and nvcc's register/spill report); the native scalar
             prep must be in use.
2. kernels — the split-k verify kernel against its plain PyTorch version on
             the card at buckets 256, 1024 (the interactive batch), 4096 and
             32768 (verdicts bit-identical; CUDA-event medians of both, and
             the card's least time for the same work).
3. service — SignatureBatcher(device="cuda") driven through submit_group
             (bulk groups of 32768), a 1024-item interactive group, single
             submits and a few secp256k1 checks (host queue); verdicts must
             match the construction and a random 256 the host oracle; no
             batch may fail over to the host, every breaker stays closed and
             the kernel's launch counter must move. The bulk groups then run
             once more under torch.profiler (CORDA_TPU_PROFILE_DIR), whose
             trace gives the card's busy share of that window.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout of the
repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

#: Peak rates of one H100 SXM (NVIDIA data-sheet dense figures at the
#: 700 W limit): 3.35 TB/s of HBM; 67 TFLOP/s float32 outside
#: the tensor cores, i.e. 128 FMA lanes a clock per SM. Integer multiply-add
#: (IMAD) issues at half the float32 lane rate (64 a clock per SM on compute
#: capability 9.0), so 67e12 / 2 / 2 = 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
#: Per signature (see csrc/ed25519_split.cu): 1303 field multiplications of
#: 64 + 8 32x32->64 products and 766 squarings of 36 + 8 (the triangular
#: square the function needs, whatever the kernel does), each product
#: counted as 2 IMAD issue slots.
FIELD_MULS_PER_SIG, FIELD_SQRS_PER_SIG = 1303, 766
IMAD_PER_SIG = 2 * (FIELD_MULS_PER_SIG * (64 + 8)
                    + FIELD_SQRS_PER_SIG * (36 + 8))
#: Bytes a verify must move: the wire arrays per item (bb_idx 64, a_packed
#: 64, rows 192, r_packed 32) and the verdict, plus the six Niels tables once.
BYTES_PER_SIG = 64 + 64 + 192 + 32 + 1
TABLE_BYTES = 6 * 65536 * 32

BUCKETS = (256, 1024, 4096, 32768)
#: Service-phase shape: 512 signers over 2048 distinct messages (host
#: signing costs ~5 ms a signature), 8 bulk groups of 32768, 25 interactive
#: 1k groups, 20 single submits; 5 timed kernel runs per bucket.
SIGNERS, MESSAGES = 512, 2048
BULK_GROUPS, INTERACTIVE_RUNS, SINGLES, RUNS = 8, 25, 20, 5


def log(*a):
    print(*a, flush=True)


def bound_ms(n: int) -> tuple[float, str]:
    ops_s = n * IMAD_PER_SIG / IMAD_PER_S
    bytes_s = (n * BYTES_PER_SIG + TABLE_BYTES) / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def time_cuda(fn, runs: int) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_s(trace_path: str) -> tuple[float, float]:
    """(seconds the card was busy, seconds of kernel time) in an exported
    torch.profiler Chrome trace: the union of its kernel, copy and memset
    intervals, and the sum of its kernel intervals."""
    events = json.load(open(trace_path))["traceEvents"]
    spans, kernel_us = [], 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if cat == "kernel":
                kernel_us += float(e["dur"])
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e6, kernel_us / 1e6


def make_dataset(seed: int, n_signers: int, n_msgs: int):
    """Signed (pub, sig, msg) items from ``seed`` with the port's own host
    signing, every item valid."""
    from corda_tpu_torch.core.crypto import ecmath
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(n_signers)]
    pubs = [ecmath.ed25519_public_key(s) for s in seeds]
    items = []
    for i in range(n_msgs):
        j = i % n_signers
        msg = rng.randbytes(48 + i % 64)
        items.append((pubs[j], ecmath.ed25519_sign(seeds[j], msg, public=pubs[j]),
                      msg))
    return items


def tamper(item, kind: int, other_pub: bytes):
    """One of seven invalid variants of a valid item."""
    from corda_tpu_torch.core.crypto import ecmath
    pub, sig, msg = item
    if kind == 0:        # flipped signature bit (in s)
        return pub, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], msg
    if kind == 1:        # flipped message bit
        return pub, sig, msg[:-1] + bytes([msg[-1] ^ 1])
    if kind == 2:        # the wrong key
        return other_pub, sig, msg
    if kind == 3:        # s >= L
        s = int.from_bytes(sig[32:], "little") + ecmath.ED_L
        return pub, sig[:32] + s.to_bytes(32, "little"), msg
    if kind == 4:        # flipped R sign bit
        return pub, sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:], msg
    if kind == 5:        # non-canonical R y (>= p)
        return pub, (2**255 - 10).to_bytes(32, "little") + sig[32:], msg
    return b"\xff" * 32, sig, msg   # undecompressible key


def tile(base, n: int, seed: int):
    """``n`` items cycling through ``base``; 1/16 of them tampered (the
    seven kinds in turn). Returns (items, expected verdicts)."""
    rng = random.Random(seed)
    items, want = [], []
    for i in range(n):
        it = base[i % len(base)]
        if i % 16 == 5:
            other = base[(i + 1) % len(base)][0]
            it = tamper(it, (i // 16) % 7, other)
            want.append(False)
        else:
            want.append(True)
        items.append(it)
    order = list(range(n))
    rng.shuffle(order)
    return [items[k] for k in order], [want[k] for k in order]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017,
                    help="seed of the signers, messages and tampering")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from corda_tpu_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: corda_tpu_torch is not importable ({exc}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2

    # -- phase 1: probe and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s wall, per library "
        f"{json.dumps(_build.BUILD_SECONDS)}")
    for line in _build.BUILD_LOG.get("ed25519_split", "").splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"ptxas: {line.strip()}")
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import scalarprep
    if not scalarprep.available():
        raise SystemExit("native scalar prep is not in use")
    log("scalarprep: native")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    base = make_dataset(args.seed, SIGNERS, MESSAGES)
    log(f"dataset: {len(base)} signed messages from {SIGNERS} signers "
        f"in {time.perf_counter() - t0:.1f} s")
    tables = ed.split_tables(dev)

    # -- phase 2: kernel against its plain version --------------------------
    per_bucket = {}
    for bucket in BUCKETS:
        items, want = tile(base, bucket, args.seed + bucket)
        *wire, precheck = ed.prepare_batch_split(items)
        dargs = ed.wire_to_device(*wire, device=dev)
        ok_k = ed.verify_core_split(*dargs, *tables)
        ok_p = ed.verify_core_split_plain(*dargs, *tables)
        torch.cuda.synchronize()
        k = ok_k.cpu().numpy()
        p = ok_p.cpu().numpy()
        if not (k == p).all():
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"bucket {bucket}: {(k != p).sum()} verdicts")
        if list(k & precheck) != want:
            raise SystemExit(f"verdicts disagree with the construction at "
                             f"bucket {bucket}")
        ms = time_cuda(lambda: ed.verify_core_split(*dargs, *tables),
                       RUNS)
        plain = time_cuda(lambda: ed.verify_core_split_plain(*dargs, *tables),
                          max(1, RUNS // 2) if bucket == 32768
                          else RUNS)
        bms, by = bound_ms(bucket)
        err = int(abs(k.astype(int) - p.astype(int)).max())
        per_bucket[bucket] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                              "bound_by": by, "max_abs_err": err}
        log(json.dumps({"bucket": bucket, "identical": True,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by,
                        "sig_per_s": bucket / (ms / 1e3), "card": card}))
    log("library_ms: null — no PyTorch call computes Ed25519 verification")

    # -- phase 3: the service path -------------------------------------------
    from corda_tpu_torch.core.crypto import Crypto, PublicKey
    from corda_tpu_torch.core.crypto import generate_keypair
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     EDDSA_ED25519_SHA512)
    from corda_tpu_torch.observability import (KernelProfiler, get_profiler,
                                               set_profiler)
    from corda_tpu_torch.ops.staging import get_staging_pool
    from corda_tpu_torch.verifier import SignatureBatcher

    def checks_of(items):
        return [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]

    bulk_items, bulk_want = tile(base, 32768, args.seed + 1)
    bulk = checks_of(bulk_items)
    inter_items, inter_want = tile(base, 1024, args.seed + 2)
    inter = checks_of(inter_items)
    k1 = generate_keypair(ECDSA_SECP256K1_SHA256, entropy=bytes(31) + b"\x07")
    k1_msg = b"secp256k1 takes the host queue"
    k1_sig = Crypto.sign_with_key(k1, k1_msg).bytes
    k1_checks = [(k1.public, k1_sig, k1_msg),
                 (k1.public, k1_sig[:-1] + bytes([k1_sig[-1] ^ 1]), k1_msg)]

    batcher = SignatureBatcher(device="cuda")
    # warm-up outside the counted run: first-use table upload and pinned
    # buffer allocation at both shapes
    batcher.submit_group(bulk).result(timeout=600)
    batcher.submit_group(inter, latency_class="interactive").result(timeout=600)
    batcher.close()

    batcher = SignatureBatcher(device="cuda")
    set_profiler(KernelProfiler())
    ed.verify_core_split.launches = 0
    t0 = time.perf_counter()
    futs = [batcher.submit_group(bulk) for _ in range(BULK_GROUPS)]
    submit_s = time.perf_counter() - t0
    bulk_got = [f.result(timeout=900) for f in futs]
    bulk_s = time.perf_counter() - t0
    bulk_snap = batcher.metrics.snapshot()
    inter_lat, inter_got = [], None
    for _ in range(INTERACTIVE_RUNS):
        t1 = time.perf_counter()
        inter_got = batcher.submit_group(
            inter, latency_class="interactive").result(timeout=600)
        inter_lat.append(time.perf_counter() - t1)
    single_lat, single_got = [], []
    for i in range(SINGLES):
        c = bulk[i]
        t1 = time.perf_counter()
        single_got.append(batcher.submit(*c).result(timeout=120))
        single_lat.append(time.perf_counter() - t1)
    k1_got = batcher.submit_group(k1_checks).result(timeout=120)
    launches = ed.verify_core_split.launches
    breakers = batcher.breaker_status()
    snap = batcher.metrics.snapshot()
    batcher.close()

    for got in bulk_got:
        if got != bulk_want:
            raise SystemExit("bulk verdicts disagree with the construction")
    if inter_got != inter_want:
        raise SystemExit("interactive verdicts disagree with the construction")
    if single_got != bulk_want[:SINGLES]:
        raise SystemExit("single-submit verdicts disagree with the construction")
    if k1_got != [True, False]:
        raise SystemExit(f"secp256k1 host-queue verdicts wrong: {k1_got}")
    rng = random.Random(args.seed + 3)
    for i in rng.sample(range(len(bulk)), 256):
        if Crypto.is_valid(*bulk[i]) != bulk_want[i]:
            raise SystemExit(f"host oracle disagrees on bulk item {i}")
    device_route = (BULK_GROUPS * len(bulk)
                    + INTERACTIVE_RUNS * len(inter))

    def count(name):
        return snap.get(name, {}).get("count", 0)

    if count("SigBatcher.BatchFailure") != 0:
        raise SystemExit("a device batch failed over to the host")
    if count("SigBatcher.DeviceChecked") != device_route:
        raise SystemExit(f"DeviceChecked {count('SigBatcher.DeviceChecked')} "
                         f"!= device-route items {device_route}")
    if any(b["state"] != "closed" for b in breakers.values()):
        raise SystemExit(f"a breaker is not closed: {breakers}")
    if launches == 0:
        raise SystemExit("the main path launched the kernel no time")
    prep = bulk_snap.get("SigBatcher.ed25519.Prep", {})
    dur = bulk_snap.get("SigBatcher.ed25519.Duration", {})
    inter_lat.sort()
    single_lat.sort()
    service = {
        "card": card,
        "service_verifies_per_s": BULK_GROUPS * len(bulk) / bulk_s,
        "bulk_items": BULK_GROUPS * len(bulk), "bulk_wall_s": bulk_s,
        "interactive_1k_p50_ms": 1e3 * statistics.median(inter_lat),
        "interactive_1k_p99_ms": 1e3 * inter_lat[
            min(len(inter_lat) - 1, int(0.99 * len(inter_lat)))],
        "interactive_runs": len(inter_lat),
        "single_submit_p50_ms": 1e3 * statistics.median(single_lat),
        "single_submit_route": "host (below host_crossover=192)",
        "device_batches": count("SigBatcher.DeviceBatches"),
        "device_checked": count("SigBatcher.DeviceChecked"),
        "host_routed": count("SigBatcher.HostRouted"),
        "batch_failures": count("SigBatcher.BatchFailure"),
        "kernel_launches": launches,
        "bulk_submit_s": submit_s,
        "bulk_prep_mean_ms": 1e3 * prep.get("mean_s", 0.0),
        "bulk_prep_max_ms": 1e3 * prep.get("max_s", 0.0),
        "bulk_finish_wait_mean_ms": 1e3 * dur.get("mean_s", 0.0),
        "bulk_device_busy_share_est": BULK_GROUPS * per_bucket[32768]["ms"]
        / 1e3 / bulk_s,
        "prep_device_overlap_pct": get_profiler().snapshot()["overlap"][
            "overlap_pct"],
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "staging": get_staging_pool().stats(),
    }

    # the same bulk groups once more under torch.profiler: the exported
    # trace's device intervals give the card's busy share of the window
    with tempfile.TemporaryDirectory() as prof_dir:
        os.environ["CORDA_TPU_PROFILE_DIR"] = prof_dir
        try:
            batcher = SignatureBatcher(device="cuda")
            t0 = time.perf_counter()
            futs = [batcher.submit_group(bulk) for _ in range(BULK_GROUPS)]
            traced_got = [f.result(timeout=900) for f in futs]
            traced_s = time.perf_counter() - t0
            batcher.close()
        finally:
            del os.environ["CORDA_TPU_PROFILE_DIR"]
        (trace,) = glob.glob(os.path.join(prof_dir, "sig-batcher-*.json"))
        busy_s, kernel_s = device_busy_s(trace)
    if any(got != bulk_want for got in traced_got):
        raise SystemExit("traced bulk verdicts disagree with the construction")
    if kernel_s == 0.0:
        raise SystemExit("the profiler trace holds no kernel on the card")
    service.update({
        "traced_bulk_wall_s": traced_s,
        "traced_device_busy_s": busy_s,
        "traced_kernel_s": kernel_s,
        "traced_device_idle_share": 1.0 - busy_s / traced_s,
    })
    log(json.dumps(service))

    top = per_bucket[32768]
    kernels = {"kernels": [{
        "name": "ed25519_split_verify", "route": "cuda",
        "source": "corda_tpu_torch/csrc/ed25519_split.cu",
        "replaces": "corda_tpu/ops/ed25519.py:346",
        "launches": launches,
        "max_abs_err": max(b["max_abs_err"] for b in per_bucket.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None}]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
