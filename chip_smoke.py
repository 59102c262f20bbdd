#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch on one NVIDIA GPU: builds every kernel of the
port from the sources in this checkout, holds each against its plain PyTorch
version, and drives the signature-verification service paths end to end:
Ed25519 and ECDSA (secp256k1, secp256r1).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. probe   — card name and power limit (nvidia-smi), torch/CUDA versions,
             parallel build of the three CUDA kernel libraries and
             libscalarmath (seconds, and nvcc's register/spill report); the
             native scalar prep must be in use.
2. kernels — each kernel against its plain PyTorch version on the card at
             buckets 256, 1024 (the interactive batch), 4096 and 32768:
             B2 Ed25519 split-k, B3 secp256k1 hybrid GLV and B4 secp256r1
             half-gcd split, on adversarial batches from the smoke's own
             signing (B3's with crafted r + n < p signatures, B4's with
             half-gcd fallbacks). Verdicts bit-identical and equal to the
             construction; CUDA-event medians of both versions, and the
             card's least time for the same work.
3. service — SignatureBatcher(device="cuda") driven through submit_group:
             Ed25519 (bulk groups of 32768, 1024-item interactive groups,
             single submits), then secp256k1 and secp256r1 (bulk groups of
             32768 and interactive 1024 groups each), then a mixed
             Ed25519/secp256k1/secp256r1 verify_signed run through the
             verifier service. Verdicts must match the construction and a
             random 256 per scheme the host oracle; no batch may fail over to
             the host, every breaker stays closed, and each path's kernels
             must have launched (counts set to 0 just before each path and
             read just after; the kernels line gives each kernel's count on
             its own scheme's path, the mixed run's are printed with the
             ECDSA results). Each path's bulk groups then run once more
             under torch.profiler (CORDA_TPU_PROFILE_DIR), whose trace gives
             the card's busy share of that window.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout of the
repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import glob
import json
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

#: Peak rates of one H100 SXM (NVIDIA data-sheet dense figures at the
#: 700 W limit): 3.35 TB/s of HBM; 67 TFLOP/s float32 outside
#: the tensor cores, i.e. 128 FMA lanes a clock per SM. Integer multiply-add
#: (IMAD) issues at half the float32 lane rate (64 a clock per SM on compute
#: capability 9.0), so 67e12 / 2 / 2 = 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4


def imad_per_sig(products: int, squarings: int, fold: int) -> int:
    """Field products of 64 + ``fold`` 32x32->64 multiplies and squarings
    of 36 + ``fold`` (the triangular square the function needs, whatever a
    kernel does), each multiply counted as 2 IMAD issue slots. ``fold`` is
    the reduction's own multiplies: 8 where the high half is multiplied
    back in (x 38 for p25519, x 977 for secp256k1), 0 for P-256, whose
    FIPS 186-4 fast reduction only adds and subtracts words."""
    return 2 * (products * (64 + fold) + squarings * (36 + fold))


#: Per signature, counted in each kernel's source note:
#: B2 (csrc/ed25519_split.cu): 1303 products, 766 squarings; wire arrays
#: bb_idx 64, a_packed 64, rows 192, r_packed 32 and the verdict, plus the
#: six Niels tables once.
#: B3 (csrc/secp256k1_hybrid.cu): 1823 products, 256 squarings; wire g_idx
#: 64, q_bits 64, pts 128, r_limbs 32 and the verdict, plus each distinct
#: G-table row gathered (x 32 + y 32 + flag 1 bytes).
#: B4 (csrc/secp256r1_split.cu): 2044 products, 393 squarings; wire g_idx
#: 64, q_digits 32, q_x/q_y 64, xd 32 and the verdict, plus each distinct
#: row gathered from the G and G' tables.
KERNELS = {
    "ed25519_split_verify": {
        "imad": imad_per_sig(1303, 766, 8), "wire": 64 + 64 + 192 + 32 + 1,
        "source": "corda_tpu_torch/csrc/ed25519_split.cu",
        "replaces": "corda_tpu/ops/ed25519.py:346", "lib": "ed25519_split"},
    "secp256k1_hybrid_verify": {
        "imad": imad_per_sig(1823, 256, 8), "wire": 64 + 64 + 128 + 32 + 1,
        "source": "corda_tpu_torch/csrc/secp256k1_hybrid.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1276",
        "lib": "secp256k1_hybrid"},
    "secp256r1_split_verify": {
        "imad": imad_per_sig(2044, 393, 0), "wire": 64 + 32 + 64 + 32 + 1,
        "source": "corda_tpu_torch/csrc/secp256r1_split.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1063",
        "lib": "secp256r1_split"},
}
NIELS_TABLE_BYTES = 6 * 65536 * 32
G_ROW_BYTES = 32 + 32 + 1

BUCKETS = (256, 1024, 4096, 32768)
#: Service-phase shape. Ed25519: 512 signers over 2048 distinct signed
#: messages, 8 bulk groups of 32768, 25 interactive 1k groups, 20 single
#: submits. ECDSA, per curve: 64 signers over 256 distinct messages (host
#: signing is pure Python, ~0.1 s a signature, spread over a process pool),
#: 4 bulk groups of 32768 and 10 interactive 1k groups; then 512 mixed
#: three-signature transactions through verify_signed. 5 timed kernel runs
#: per bucket (3 of the plain versions, 2 at 32768).
SIGNERS, MESSAGES = 512, 2048
BULK_GROUPS, INTERACTIVE_RUNS, SINGLES, RUNS = 8, 25, 20, 5
EC_SIGNERS, EC_MESSAGES = 64, 256
EC_BULK_GROUPS, EC_INTERACTIVE_RUNS, MIXED_TXS = 4, 10, 512
ORACLE_SAMPLE = 256


def log(*a):
    print(*a, flush=True)


def bound_ms(kernel: str, n: int, table_bytes: int) -> tuple[float, str]:
    """The card's least time for ``n`` verifies of ``kernel``: the larger
    of its IMAD count over the IMAD rate and its bytes over the HBM rate."""
    k = KERNELS[kernel]
    ops_s = n * k["imad"] / IMAD_PER_S
    bytes_s = (n * k["wire"] + table_bytes) / HBM_BYTES_PER_S
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


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

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
    """One of seven invalid variants of a valid Ed25519 item."""
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


def tile(base, n: int, seed: int, tamper_fn=tamper):
    """``n`` items cycling through ``base``; 1/16 of them tampered (the
    seven kinds in turn). Returns (items, expected verdicts)."""
    rng = random.Random(seed)
    items, want = [], []
    for i in range(n):
        it = base[i % len(base)]
        if i % 16 == 5:
            other = base[(i + 1) % len(base)][0]
            it = tamper_fn(it, (i // 16) % 7, other)
            want.append(False)
        else:
            want.append(True)
        items.append(it)
    order = list(range(n))
    rng.shuffle(order)
    return [items[k] for k in order], [want[k] for k in order]


def _curve(name: str):
    from corda_tpu_torch.core.crypto import ecmath
    return ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1


def _ecdsa_key_job(job):
    curve_name, priv = job
    curve = _curve(curve_name)
    return curve.mul(priv, curve.g)


def _ecdsa_sign_job(job):
    from corda_tpu_torch.core.crypto import ecmath
    curve_name, priv, msg = job
    return ecmath.ecdsa_sign(_curve(curve_name), priv, msg)


def _ecdsa_oracle_job(job):
    """The host oracle on one (pub, msg, r, s) item (pub may be None)."""
    from corda_tpu_torch.core.crypto import ecmath
    curve_name, (pub, msg, r, s) = job
    return pub is not None and ecmath.ecdsa_verify(_curve(curve_name), pub,
                                                   msg, r, s)


def make_ecdsa_dataset(pool, curve_name: str, seed: int, n_signers: int,
                       n_msgs: int):
    """Valid (pub, msg, r, s) items of ``curve_name`` from ``seed``, keys
    derived and messages signed by the port's host ecmath on a process
    pool. Returns (items, private keys, public points); item i is signed by
    signer i mod ``n_signers``."""
    curve = _curve(curve_name)
    rng = random.Random(seed)
    privs = [rng.randrange(1, curve.n) for _ in range(n_signers)]
    pubs = list(pool.map(_ecdsa_key_job, [(curve_name, d) for d in privs]))
    jobs = [(curve_name, privs[i % n_signers], rng.randbytes(32 + i % 48))
            for i in range(n_msgs)]
    sigs = list(pool.map(_ecdsa_sign_job, jobs, chunksize=8))
    items = [(pubs[i % n_signers], job[2], r, s)
             for i, (job, (r, s)) in enumerate(zip(jobs, sigs))]
    return items, privs, pubs


def tamper_ecdsa(curve, item, kind: int, other_pub):
    """One of seven invalid variants of a valid ECDSA item."""
    pub, msg, r, s = item
    if kind == 0:        # flipped message bit
        return pub, msg[:-1] + bytes([msg[-1] ^ 1]), r, s
    if kind == 1:        # the wrong key
        return other_pub, msg, r, s
    if kind == 2:        # tampered s
        return pub, msg, r, s + 1 if s + 1 <= curve.n // 2 else s - 1
    if kind == 3:        # the high-s twin (rejected by the low-s rule)
        return pub, msg, r, curve.n - s
    if kind == 4:        # r = 0
        return pub, msg, 0, s
    if kind == 5:        # r >= n
        return pub, msg, r + curve.n, s
    return None, msg, r, s   # no decodable key


def crafted_rn(curve, rng, valid: bool):
    """A signature whose R has x(R) = r + n < p, unreachable by honest
    signing: R is chosen first and the key solved for,
    Q = r^-1 (s·R - e·G). B3 accepts it through its r + n candidate; B4
    sends it to the host (a half-gcd fallback)."""
    import hashlib
    from corda_tpu_torch.core.crypto import ecmath
    p, n = curve.p, curve.n
    while True:
        x = n + rng.randrange(1, 1 << 60)
        z = (x * x * x + curve.a * x + curve.b) % p
        y = pow(z, (p + 1) // 4, p)
        if y * y % p == z:
            break
    msg = rng.randbytes(40)
    r = x - n
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), n) % n
    s = rng.randrange(1, n // 2)
    Q = curve.mul(pow(r, n - 2, n), curve.add(curve.mul(s, (x, y)),
                                              curve.mul(n - e, curve.g)))
    return (Q, msg, r, s if valid else (s + 1 if s + 1 <= n // 2 else s - 1))


def to_check(curve, scheme, item):
    """(pub point or None, msg, r, s) → the service's (PublicKey, DER
    signature, content); a missing key becomes an undecodable encoding."""
    from corda_tpu_torch.core.crypto import PublicKey, ecmath
    from corda_tpu_torch.core.crypto.keys import sec1_compress
    pub, msg, r, s = item
    enc = (sec1_compress(curve, pub) if pub is not None
           else b"\x02" + b"\xff" * 32)
    return (PublicKey(scheme, enc), ecmath.ecdsa_sig_to_der(r, s), msg)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def compare_kernel(name, kernel, plain, args, tables, bucket, table_bytes,
                   final_fn, want, card):
    """One bucket of phase 2: the kernel against its plain version on the
    same tensors (bit-identical verdicts), the verdicts after the host
    masks against the construction, and both versions' times."""
    import torch
    ok_k = kernel(*args, *tables)
    ok_p = plain(*args, *tables)
    torch.cuda.synchronize()
    k = ok_k.cpu().numpy()
    p = ok_p.cpu().numpy()
    if not (k == p).all():
        raise SystemExit(f"{name} disagrees with its plain version at "
                         f"bucket {bucket}: {(k != p).sum()} verdicts")
    if list(final_fn(k)) != want:
        raise SystemExit(f"{name} verdicts disagree with the construction "
                         f"at bucket {bucket}")
    ms = time_cuda(lambda: kernel(*args, *tables), RUNS)
    plain_ms = time_cuda(lambda: plain(*args, *tables),
                         2 if bucket == 32768 else 3)
    bms, by = bound_ms(name, bucket, table_bytes)
    err = int(abs(k.astype(int) - p.astype(int)).max())
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err}
    log(json.dumps({"kernel": name, "bucket": bucket, "identical": True,
                    **row, "sig_per_s": bucket / (ms / 1e3), "card": card}))
    return row


def ecdsa_kernel_batch(curve, base, bucket: int, seed: int):
    """An adversarial bucket for phase 2: ``base`` tiled with 1/16
    tampered, plus two crafted r + n < p signatures (one valid) and two
    tiny-r signatures at fixed places. Returns (items, want)."""
    items, want = tile(base, bucket, seed,
                       lambda it, kind, other: tamper_ecdsa(curve, it, kind,
                                                            other))
    rng = random.Random(seed)
    for pos, valid in ((3, True), (bucket // 2, False)):
        items[pos] = crafted_rn(curve, rng, valid)
        want[pos] = valid
    for pos in (7, bucket - 2):
        pub, msg, _, s = base[pos % len(base)]
        items[pos] = (pub, msg, 1000 + pos, s)
        want[pos] = False
    return items, want


def traced_window(batcher_factory, groups, want):
    """Run ``groups`` (lists of checks) once more under torch.profiler and
    return (wall s, busy s, kernel s) of the window from the trace."""
    with tempfile.TemporaryDirectory() as prof_dir:
        os.environ["CORDA_TPU_PROFILE_DIR"] = prof_dir
        try:
            batcher = batcher_factory()
            t0 = time.perf_counter()
            futs = [batcher.submit_group(g) for g in groups]
            got = [f.result(timeout=900) for f in futs]
            wall = time.perf_counter() - t0
            batcher.close()
        finally:
            del os.environ["CORDA_TPU_PROFILE_DIR"]
        (trace,) = glob.glob(os.path.join(prof_dir, "sig-batcher-*.json"))
        busy_s, kernel_s = device_busy_s(trace)
    if got != want:
        raise SystemExit("traced verdicts disagree with the construction")
    if kernel_s == 0.0:
        raise SystemExit("the profiler trace holds no kernel on the card")
    return wall, busy_s, kernel_s


class SmokeTransaction:
    """A transaction as the verifier service sees it (``id``, ``sigs``,
    coverage and ledger resolution), standing in for a SignedTransaction,
    which the port does not have yet: every key signs the id, and the
    ledger transaction's contract check passes."""

    class _Ledger:
        def verify(self):
            return None

    def __init__(self, tx_id, sigs):
        self.id = tx_id
        self.sigs = sigs

    def get_missing_signatures(self):
        return set()

    def to_ledger_transaction(self, services):
        return self._Ledger()


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
    for kernel in KERNELS.values():
        for line in _build.BUILD_LOG.get(kernel["lib"], "").splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"ptxas {kernel['lib']}: {line.strip()}")
    import numpy as np
    from corda_tpu_torch.core.crypto import ecmath
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import scalarprep
    from corda_tpu_torch.ops import weierstrass as wc
    if not scalarprep.available():
        raise SystemExit("native scalar prep is not in use")
    log("scalarprep: native")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    base = make_dataset(args.seed, SIGNERS, MESSAGES)
    log(f"dataset: {len(base)} Ed25519 signed messages from {SIGNERS} "
        f"signers in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        ec_data = {name: make_ecdsa_dataset(pool, name, args.seed + k,
                                            EC_SIGNERS, EC_MESSAGES)
                   for k, name in enumerate(("secp256k1", "secp256r1"))}
    ec_base = {name: data[0] for name, data in ec_data.items()}
    log(f"dataset: {EC_MESSAGES} ECDSA signed messages per curve from "
        f"{EC_SIGNERS} signers in {time.perf_counter() - t0:.1f} s")
    tables = ed.split_tables(dev)
    k1_tables = wc.hybrid_tables(dev)
    r1_tables = wc.r1_split_tables(dev)

    # -- phase 2: each kernel against its plain version ---------------------
    per_kernel = {name: {} for name in KERNELS}
    for bucket in BUCKETS:
        items, want = tile(base, bucket, args.seed + bucket)
        *wire, precheck = ed.prepare_batch_split(items)
        dargs = ed.wire_to_device(*wire, device=dev)
        per_kernel["ed25519_split_verify"][bucket] = compare_kernel(
            "ed25519_split_verify", ed.verify_core_split,
            ed.verify_core_split_plain, dargs, tables, bucket,
            NIELS_TABLE_BYTES, lambda k: k & precheck, want, card)

        curve = ecmath.SECP256K1
        items, want = ecdsa_kernel_batch(curve, ec_base["secp256k1"], bucket,
                                         args.seed + 3 * bucket)
        *wire, precheck = wc.prepare_batch_hybrid_wide(items)
        rows = np.unique(wire[0] & ((1 << 18) - 1)).size
        per_kernel["secp256k1_hybrid_verify"][bucket] = compare_kernel(
            "secp256k1_hybrid_verify", wc.verify_core_hybrid_wide,
            wc.verify_core_hybrid_wide_plain,
            wc.wire_to_device(wire, dev), k1_tables, bucket,
            rows * G_ROW_BYTES, lambda k: k & precheck, want, card)

        curve = ecmath.SECP256R1
        items, want = ecdsa_kernel_batch(curve, ec_base["secp256r1"], bucket,
                                         args.seed + 5 * bucket)
        *wire, precheck, forced = wc.prepare_batch_r1_split(curve, items)
        rows = (np.unique(wire[0][:, 0]).size
                + np.unique(wire[0][:, 1]).size)
        per_kernel["secp256r1_split_verify"][bucket] = compare_kernel(
            "secp256r1_split_verify", wc.verify_core_r1_split,
            wc.verify_core_r1_split_plain,
            wc.wire_to_device(wire, dev), r1_tables, bucket,
            rows * G_ROW_BYTES, lambda k: (k & precheck) | forced, want,
            card)
    log("library_ms: null — no PyTorch call computes Ed25519 or ECDSA "
        "verification")

    # -- phase 3: the service paths ------------------------------------------
    from corda_tpu_torch.core.crypto import Crypto, PublicKey
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     ECDSA_SECP256R1_SHA256,
                                                     EDDSA_ED25519_SHA512)
    from corda_tpu_torch.core.crypto.secure_hash import SecureHash
    from corda_tpu_torch.observability import (KernelProfiler, get_profiler,
                                               set_profiler)
    from corda_tpu_torch.ops.staging import get_staging_pool
    from corda_tpu_torch.verifier import (SignatureBatcher,
                                          TpuTransactionVerifierService)

    def checks_of(items):
        return [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]

    def count(snap, name):
        return snap.get(name, {}).get("count", 0)

    def require_clean(snap, breakers, device_route, label):
        if count(snap, "SigBatcher.BatchFailure") != 0:
            raise SystemExit(f"{label}: a device batch failed over to the "
                             "host")
        if count(snap, "SigBatcher.DeviceChecked") != device_route:
            raise SystemExit(
                f"{label}: DeviceChecked "
                f"{count(snap, 'SigBatcher.DeviceChecked')} != device-route "
                f"items {device_route}")
        if any(b["state"] != "closed" for b in breakers.values()):
            raise SystemExit(f"{label}: a breaker is not closed: {breakers}")

    # Ed25519
    bulk_items, bulk_want = tile(base, 32768, args.seed + 1)
    bulk = checks_of(bulk_items)
    inter_items, inter_want = tile(base, 1024, args.seed + 2)
    inter = checks_of(inter_items)

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
    ed_launches = ed.verify_core_split.launches
    breakers = batcher.breaker_status()
    snap = batcher.metrics.snapshot()
    batcher.close()
    ed_overlap = get_profiler().snapshot()["overlap"]["overlap_pct"]

    for got in bulk_got:
        if got != bulk_want:
            raise SystemExit("bulk verdicts disagree with the construction")
    if inter_got != inter_want:
        raise SystemExit("interactive verdicts disagree with the construction")
    if single_got != bulk_want[:SINGLES]:
        raise SystemExit("single-submit verdicts disagree with the construction")
    rng = random.Random(args.seed + 3)
    for i in rng.sample(range(len(bulk)), ORACLE_SAMPLE):
        if Crypto.is_valid(*bulk[i]) != bulk_want[i]:
            raise SystemExit(f"host oracle disagrees on bulk item {i}")
    require_clean(snap, breakers,
                  BULK_GROUPS * len(bulk) + INTERACTIVE_RUNS * len(inter),
                  "ed25519")
    if ed_launches == 0:
        raise SystemExit("the Ed25519 path launched its kernel no time")
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
        "device_batches": count(snap, "SigBatcher.DeviceBatches"),
        "device_checked": count(snap, "SigBatcher.DeviceChecked"),
        "host_routed": count(snap, "SigBatcher.HostRouted"),
        "batch_failures": count(snap, "SigBatcher.BatchFailure"),
        "kernel_launches": ed_launches,
        "bulk_submit_s": submit_s,
        "bulk_prep_mean_ms": 1e3 * prep.get("mean_s", 0.0),
        "bulk_prep_max_ms": 1e3 * prep.get("max_s", 0.0),
        "bulk_finish_wait_mean_ms": 1e3 * dur.get("mean_s", 0.0),
        "bulk_device_busy_share_est": BULK_GROUPS
        * per_kernel["ed25519_split_verify"][32768]["ms"] / 1e3 / bulk_s,
        "prep_device_overlap_pct": ed_overlap,
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "staging": get_staging_pool().stats(),
    }
    traced_s, busy_s, kernel_s = traced_window(
        lambda: SignatureBatcher(device="cuda"), [bulk] * BULK_GROUPS,
        [bulk_want] * BULK_GROUPS)
    service.update({
        "traced_bulk_wall_s": traced_s,
        "traced_device_busy_s": busy_s,
        "traced_kernel_s": kernel_s,
        "traced_device_idle_share": 1.0 - busy_s / traced_s,
    })
    log(json.dumps({"path": "ed25519", **service}))

    # ECDSA: secp256k1 and secp256r1 bulk and interactive groups
    schemes = {"secp256k1": ECDSA_SECP256K1_SHA256,
               "secp256r1": ECDSA_SECP256R1_SHA256}
    ec_bulk, ec_inter = {}, {}
    for k, (name, scheme) in enumerate(schemes.items()):
        curve = _curve(name)

        def tamper_fn(it, kind, other, curve=curve):
            return tamper_ecdsa(curve, it, kind, other)
        items, want = tile(ec_base[name], 32768, args.seed + 11 + k,
                           tamper_fn)
        ec_bulk[name] = ([to_check(curve, scheme, it) for it in items], want,
                         items)
        items, want = tile(ec_base[name], 1024, args.seed + 13 + k,
                           tamper_fn)
        ec_inter[name] = ([to_check(curve, scheme, it) for it in items], want)

    batcher = SignatureBatcher(device="cuda")
    for name in schemes:
        batcher.submit_group(ec_bulk[name][0]).result(timeout=600)
        batcher.submit_group(ec_inter[name][0],
                             latency_class="interactive").result(timeout=600)
    batcher.close()

    batcher = SignatureBatcher(device="cuda")
    set_profiler(KernelProfiler())
    wc.verify_core_hybrid_wide.launches = 0
    wc.verify_core_r1_split.launches = 0
    ec_service = {"card": card}
    bulk_snaps = {}
    for name in schemes:
        checks, want, _ = ec_bulk[name]
        t0 = time.perf_counter()
        futs = [batcher.submit_group(checks) for _ in range(EC_BULK_GROUPS)]
        submit_s = time.perf_counter() - t0
        got = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        if any(g != want for g in got):
            raise SystemExit(f"{name} bulk verdicts disagree with the "
                             "construction")
        bulk_snaps[name] = batcher.metrics.snapshot()
        ec_service[name] = {
            "service_verifies_per_s": EC_BULK_GROUPS * len(checks) / wall,
            "bulk_items": EC_BULK_GROUPS * len(checks), "bulk_wall_s": wall,
            "bulk_submit_s": submit_s}
    for name in schemes:
        checks, want = ec_inter[name]
        lat = []
        for _ in range(EC_INTERACTIVE_RUNS):
            t1 = time.perf_counter()
            got = batcher.submit_group(
                checks, latency_class="interactive").result(timeout=600)
            lat.append(time.perf_counter() - t1)
            if got != want:
                raise SystemExit(f"{name} interactive verdicts disagree "
                                 "with the construction")
        lat.sort()
        ec_service[name].update({
            "interactive_1k_p50_ms": 1e3 * statistics.median(lat),
            "interactive_1k_max_ms": 1e3 * lat[-1],
            "interactive_runs": len(lat)})
    breakers = batcher.breaker_status()
    snap = batcher.metrics.snapshot()
    batcher.close()
    k1_launches = wc.verify_core_hybrid_wide.launches
    r1_launches = wc.verify_core_r1_split.launches
    ec_overlap = get_profiler().snapshot()["overlap"]["overlap_pct"]
    require_clean(snap, breakers, len(schemes) * (
        EC_BULK_GROUPS * 32768 + EC_INTERACTIVE_RUNS * 1024), "ecdsa")
    if k1_launches == 0 or r1_launches == 0:
        raise SystemExit("the ECDSA path launched a kernel no time: "
                         f"k1 {k1_launches}, r1 {r1_launches}")

    # mixed Ed25519/secp256k1/secp256r1 transactions through verify_signed:
    # each id signed by one signer of each scheme (the ECDSA signatures on
    # the process pool), every eighth transaction's secp256r1 signature
    # tampered
    from corda_tpu_torch.core.crypto.keys import sec1_compress
    rng = random.Random(args.seed + 17)
    ed_seeds = [rng.randbytes(32) for _ in range(16)]
    ed_pubs = [ecmath.ed25519_public_key(sd) for sd in ed_seeds]
    tx_ids = [SecureHash(rng.randbytes(32)) for _ in range(MIXED_TXS)]
    txs = [[_Sig(PublicKey(EDDSA_ED25519_SHA512, ed_pubs[t % 16]),
                 ecmath.ed25519_sign(ed_seeds[t % 16], tx_ids[t].bytes,
                                     public=ed_pubs[t % 16]))]
           for t in range(MIXED_TXS)]
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        for name, scheme in schemes.items():
            curve = _curve(name)
            _, privs, pubs = ec_data[name]
            jobs = [(name, privs[t % EC_SIGNERS], tx_ids[t].bytes)
                    for t in range(MIXED_TXS)]
            for t, (r, s) in enumerate(pool.map(_ecdsa_sign_job, jobs,
                                                chunksize=16)):
                if name == "secp256r1" and t % 8 == 3:
                    s = s + 1 if s + 1 <= curve.n // 2 else s - 1
                txs[t].append(_Sig(PublicKey(scheme, sec1_compress(
                    curve, pubs[t % EC_SIGNERS])), ecmath.ecdsa_sig_to_der(
                        r, s)))
        oracle = {}
        for k, name in enumerate(schemes):
            checks, want, items = ec_bulk[name]
            sample = random.Random(args.seed + 19 + k).sample(
                range(len(items)), ORACLE_SAMPLE)
            got = list(pool.map(_ecdsa_oracle_job,
                                [(name, items[i]) for i in sample],
                                chunksize=8))
            oracle[name] = [want[i] for i in sample] == got
    if not all(oracle.values()):
        raise SystemExit(f"host oracle disagrees with the construction: "
                         f"{oracle}")
    tx_want = [t % 8 != 3 for t in range(MIXED_TXS)]
    svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cuda", host_crossover=0))
    ed.verify_core_split.launches = 0
    wc.verify_core_hybrid_wide.launches = 0
    wc.verify_core_r1_split.launches = 0
    t0 = time.perf_counter()
    futs = [svc.verify_signed(SmokeTransaction(tx_id, sigs), None)
            for tx_id, sigs in zip(tx_ids, txs)]
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=600)
            outcomes.append(True)
        except Exception as exc:   # the outcome under test
            if type(exc).__name__ != "SignatureException":
                raise
            outcomes.append(False)
    mixed_s = time.perf_counter() - t0
    mixed_breakers = svc.batcher.breaker_status()
    mixed_snap = svc.batcher.metrics.snapshot()
    svc.shutdown()
    mixed_launches = {"ed25519": ed.verify_core_split.launches,
                      "secp256k1": wc.verify_core_hybrid_wide.launches,
                      "secp256r1": wc.verify_core_r1_split.launches}
    if outcomes != tx_want:
        raise SystemExit("verify_signed outcomes disagree with the "
                         "construction")
    require_clean(mixed_snap, mixed_breakers, 3 * MIXED_TXS, "verify_signed")
    if 0 in mixed_launches.values():
        raise SystemExit("the mixed verify_signed path launched a kernel no "
                         f"time: {mixed_launches}")
    for name in schemes:
        bs = bulk_snaps[name]
        ec_service[name].update({
            "bulk_prep_mean_ms": 1e3 * bs.get(f"SigBatcher.{name}.Prep",
                                              {}).get("mean_s", 0.0),
            "bulk_finish_wait_mean_ms": 1e3 * bs.get(
                f"SigBatcher.{name}.Duration", {}).get("mean_s", 0.0),
            "oracle_sample_agrees": oracle[name]})
    ec_service.update({
        "device_checked": count(snap, "SigBatcher.DeviceChecked"),
        "batch_failures": count(snap, "SigBatcher.BatchFailure"),
        "host_routed": count(snap, "SigBatcher.HostRouted"),
        "prep_device_overlap_pct": ec_overlap,
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "hybrid_k1_launches": k1_launches, "r1_split_launches": r1_launches,
        "r1_split_stats": wc.r1_split_stats(),
        "mixed_txs": MIXED_TXS, "mixed_wall_s": mixed_s,
        "mixed_tx_per_s": MIXED_TXS / mixed_s,
        "mixed_device_checked": count(mixed_snap,
                                      "SigBatcher.DeviceChecked"),
        "mixed_device_batches": count(mixed_snap,
                                      "SigBatcher.DeviceBatches"),
        "mixed_kernel_launches": mixed_launches,
    })
    groups, want = [], []
    for name in schemes:
        checks, w, _ = ec_bulk[name]
        groups += [checks, checks]
        want += [w, w]
    traced_s, busy_s, kernel_s = traced_window(
        lambda: SignatureBatcher(device="cuda"), groups, want)
    ec_service.update({
        "traced_bulk_groups": len(groups), "traced_bulk_wall_s": traced_s,
        "traced_device_busy_s": busy_s, "traced_kernel_s": kernel_s,
        "traced_device_idle_share": 1.0 - busy_s / traced_s})
    log(json.dumps({"path": "ecdsa", **ec_service}))

    launches = {"ed25519_split_verify": ed_launches,
                "secp256k1_hybrid_verify": k1_launches,
                "secp256r1_split_verify": r1_launches}
    rows = []
    for name, meta in KERNELS.items():
        top = per_kernel[name][32768]
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(b["max_abs_err"]
                               for b in per_kernel[name].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class _Sig:
    """A signature as the verifier service reads it (``by``, ``bytes``)."""

    def __init__(self, by, sig_bytes):
        self.by = by
        self.bytes = sig_bytes


if __name__ == "__main__":
    sys.exit(main())
