"""Frozen yardsticks: the card's peaks, the least work of a signature
verification, and the reduction of a profiler trace to device time.

Kept here so that no later change to the program moves them. The counts
are those of the port's kernel notes (field products of 64 + fold 32x32->64
multiplies and squarings of 36 + fold, each multiply 2 IMAD issue slots).
"""
from __future__ import annotations

import json

#: Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
#: 67 TFLOP/s float32 outside the tensor cores is 128 FMA lanes a clock per
#: SM; integer multiply-add issues at half the float32 lane rate (64 a
#: clock per SM on compute capability 9.0, the CUDA programming guide's
#: arithmetic-instruction throughput table), so 67e12 / 2 / 2 IMAD/s.
IMAD_PER_S = 67e12 / 4
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet (67 TFLOP/s float32) and the "
               "CUDA guide's IMAD throughput (half the FP32 rate)")


def imad_per_sig(products: int, squarings: int, fold: int) -> int:
    """Field products of 64 + ``fold`` multiplies and squarings of
    36 + ``fold``, each multiply 2 IMAD issue slots; ``fold`` is the
    reduction's own multiplies (8 for p25519 and secp256k1, 0 for P-256)."""
    return 2 * (products * (64 + fold) + squarings * (36 + fold))


#: The least IMAD count known for one verification of each scheme, whatever
#: kernel runs it: Ed25519 is B2's count (1303 products, 766 squarings),
#: below both B7 kernels' (354,240 and 329,792); secp256k1 is B3's (1823,
#: 256), secp256r1 B4's (2044, 393).
LEAST_IMAD_PER_SIG = {
    "ed25519": imad_per_sig(1303, 766, 8),      # 255,040
    "secp256k1": imad_per_sig(1823, 256, 8),    # 285,040
    "secp256r1": imad_per_sig(2044, 393, 0),    # 289,928
}

#: Substrings that name each scheme's verify kernels in a trace (Ed25519:
#: B2, one lane and pairs, and both B7 kernels).
VERIFY_KERNELS = {
    "ed25519": ("ed25519_split_verify", "ed25519_shamir_verify",
                "ed25519_windowed_verify"),
}


def device_intervals(trace_path: str):
    """(busy intervals, [(name, ts_us, dur_us)] of device events, the
    trace's events) of an exported torch.profiler Chrome trace: the union
    of its kernel, copy and memset intervals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = []
    for e in events:
        if e.get("cat", "") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            ops.append((e.get("name", "?"), float(e["ts"]), float(e["dur"])))
    spans = sorted((ts, ts + dur) for _, ts, dur in ops)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged, ops, events


def busy_seconds(merged, lo_us: float, hi_us: float) -> float:
    """Seconds of the busy intervals inside [lo_us, hi_us]."""
    total = 0.0
    for a, b in merged:
        a, b = max(a, lo_us), min(b, hi_us)
        if b > a:
            total += b - a
    return total / 1e6


# ---------------------------------------------------------------------------
# Tamper generators: seven invalid variants of a valid item each.
# ---------------------------------------------------------------------------

ED_TAMPER_KINDS = 7


def tamper_ed25519(item, kind: int, other_pub: bytes, ed_l: int):
    """One of seven invalid variants of a valid (pub, sig, msg) item."""
    pub, sig, msg = item
    if kind == 0:        # flipped signature bit (in s)
        return pub, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], msg
    if kind == 1:        # flipped message bit
        return pub, sig, msg[:-1] + bytes([msg[-1] ^ 1])
    if kind == 2:        # the wrong key
        return other_pub, sig, msg
    if kind == 3:        # s >= L
        s = int.from_bytes(sig[32:], "little") + ed_l
        return pub, sig[:32] + s.to_bytes(32, "little"), msg
    if kind == 4:        # flipped R sign bit
        return pub, sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:], msg
    if kind == 5:        # non-canonical R y (>= p)
        return pub, (2 ** 255 - 10).to_bytes(32, "little") + sig[32:], msg
    return b"\xff" * 32, sig, msg   # undecodable key


def tamper_ecdsa(n: int, item, kind: int, other_pub: bytes):
    """One of seven invalid variants of a valid (pub, msg, r, s) item."""
    pub, msg, r, s = item
    if kind == 0:        # flipped message bit
        return pub, msg[:-1] + bytes([msg[-1] ^ 1]), r, s
    if kind == 1:        # the wrong key
        return other_pub, msg, r, s
    if kind == 2:        # tampered s
        return pub, msg, r, s + 1 if s + 1 <= n // 2 else s - 1
    if kind == 3:        # the high-s twin (rejected by the low-s rule)
        return pub, msg, r, n - s
    if kind == 4:        # r = 0
        return pub, msg, 0, s
    if kind == 5:        # r >= n
        return pub, msg, r + n, s
    return b"\x02" + b"\xff" * 32, msg, r, s   # no decodable key
