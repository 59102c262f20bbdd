"""ctypes binding of native/scalarmath.cpp — batch host scalar prep.

Port of corda_tpu/ops/scalarprep.py. The C library does the per-item scalar
layer of the device verifiers in one pass per batch: Ed25519 split-k
(``sm_ed_prep``: the SHA-512 challenge mod L, the s < L range check, window
and joint-digit extraction), Ed25519 windowed (``sm_ed_prep_plain``: the
same over whole 256-bit scalars, w = 16 windows of s and 2-bit digits of
k), secp256k1 hybrid GLV (``sm_k1_prep``: precheck,
batch s-inversion, GLV split, windows, limb packing) secp256r1 half-gcd
split (``sm_r1_prep_hg``: precheck, batch s-inversion, half-gcd, t split,
R decompression, the [v2]R ladder) and secp256r1 single-scalar windows
(``sm_r1_prep``: precheck, batch s-inversion, u1/u2 and their w = 16 and
4-bit windows). It is built from the repository's
``native/scalarmath.cpp`` with g++ into ``corda_tpu_torch/_build/`` the
first time it is needed (``_build.load``); ``native/`` itself is untouched.

When no compiler is present, or the built library reports another ABI
version, ``available()`` is False and callers use the bit-identical Python
preps (``ed25519._split_windows_python``,
``weierstrass._prepare_hybrid_python``, ``_prepare_r1_split_python``), with
a warning: they are an order of magnitude slower.

Word convention: multiword integers are little-endian u64 arrays; a 256-bit
value is a (4,) row.
"""
from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from .. import _build

#: ABI gate: the library and this module move together. Version 3 is the
#: scalarmath.cpp of this repository (sm_version() returns 3).
SM_VERSION = 3

_log = logging.getLogger(__name__)

_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")

_LOCK = threading.Lock()
_STATE: dict = {}


def _bind(lib) -> None:
    lib.sm_ed_prep.restype = ctypes.c_int
    lib.sm_ed_prep.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _I32P, _I32P, _U8P, _U8P]
    lib.sm_ed_prep_plain.restype = ctypes.c_int
    lib.sm_ed_prep_plain.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _I32P, _U8P, _U8P]
    lib.sm_k1_prep.restype = ctypes.c_int
    lib.sm_k1_prep.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _U64P, _U64P,
        _I32P, _U8P, _U16P, _U16P, _U16P, _U16P, _U16P,
        _U8P, _U8P, _U64P]
    lib.sm_r1_prep_hg.restype = ctypes.c_int
    lib.sm_r1_prep_hg.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _U64P, _U64P,
        _I32P, _U8P, _U16P, _U16P, _U16P,
        _U8P, _U8P, _U64P]
    lib.sm_r1_prep.restype = ctypes.c_int
    lib.sm_r1_prep.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _U64P, _U64P,
        _I32P, _U8P, _U16P, _U16P, _U16P,
        _U8P, _U8P, _U64P]
    lib.sm_r1_halfgcd.restype = ctypes.c_int
    lib.sm_r1_halfgcd.argtypes = [_U64P, _U8P, _U64P, _U64P]
    lib.sm_mulmod.restype = ctypes.c_int
    lib.sm_mulmod.argtypes = [ctypes.c_int, _U64P, _U64P, _U64P]
    lib.sm_mod512.restype = ctypes.c_int
    lib.sm_mod512.argtypes = [ctypes.c_int, _U64P, _U64P]
    lib.sm_glv.restype = ctypes.c_int
    lib.sm_glv.argtypes = [_U64P, _U8P, _U64P, _U64P]
    lib.sm_r1p_mulfast.restype = ctypes.c_int
    lib.sm_r1p_mulfast.argtypes = [_U64P, _U64P, _U64P]


def _lib():
    """The bound library, or None (no compiler / ABI mismatch). Resolved
    once per process, at first use."""
    if "lib" in _STATE:
        return _STATE["lib"]
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        lib = None
        try:
            cand = _build.load("scalarmath")
        except (_build.BuildError, OSError) as exc:
            _log.warning("libscalarmath unavailable (%s): falling back to "
                         "the pure-Python scalar prep", exc)
        else:
            cand.sm_version.restype = ctypes.c_int
            got = cand.sm_version()
            if got != SM_VERSION:
                _log.warning("libscalarmath reports sm_version %d, need %d: "
                             "falling back to the pure-Python scalar prep",
                             got, SM_VERSION)
            else:
                _bind(cand)
                lib = cand
        _STATE["lib"] = lib
        return lib


#: Modulus ids of the test seams (as in scalarmath.cpp).
MOD_K1_N, MOD_K1_P, MOD_R1_N, MOD_R1_P, MOD_ED_L, MOD_ED_P = range(6)


def available() -> bool:
    """True when the native prep is built and has the expected ABI."""
    return _lib() is not None


def ints_to_words(xs, nwords: int = 4) -> np.ndarray:
    """Python ints → (B, nwords) LE u64 array (one C-level to_bytes each)."""
    nbytes = nwords * 8
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), nwords).copy()


def digests_to_words(digests: list[bytes], nwords: int) -> np.ndarray:
    """Big-endian digests (SHA-256 outputs) → (B, nwords) LE u64 words of
    the digest read as a big-endian integer."""
    buf = b"".join(digests)
    be = np.frombuffer(buf, dtype=">u8").reshape(len(digests), nwords)
    return be[:, ::-1].astype("<u8")


def le_digests_to_words(digests: list[bytes], nwords: int) -> np.ndarray:
    """Little-endian-integer digests (RFC 8032 SHA-512) → LE u64 words."""
    buf = b"".join(digests)
    return np.frombuffer(buf, dtype="<u8").reshape(
        len(digests), nwords).copy()


def ed_prep(h_words, s_words):
    """Ed25519 split-k prep: (B, 8) SHA-512 digest words and (B, 4) s words
    → (b_idx(8,B), b2_idx(8,B) i32, a_packed(64,B) u8, s_ok(B) bool)."""
    lib = _native()
    n = len(h_words)
    b_idx = np.empty((8, n), dtype=np.int32)
    b2_idx = np.empty((8, n), dtype=np.int32)
    a_packed = np.empty((64, n), dtype=np.uint8)
    s_ok = np.empty(n, dtype=np.uint8)
    rc = lib.sm_ed_prep(
        n, np.ascontiguousarray(h_words, dtype=np.uint64),
        np.ascontiguousarray(s_words, dtype=np.uint64),
        b_idx, b2_idx, a_packed, s_ok)
    if rc != 0:
        raise RuntimeError(f"sm_ed_prep failed: {rc}")
    return b_idx, b2_idx, a_packed, s_ok.astype(bool)


def ed_prep_plain(h_words, s_words):
    """Ed25519 windowed prep: (B, 8) digest words and (B, 4) s words →
    (b_idx (16,B) i32 w = 16 windows of s, a_digits (128,B) u8 2-bit digits
    of h mod L, s_ok (B,) bool), all MSB first; items with s >= L get
    s = k = 0."""
    lib = _native()
    n = len(h_words)
    b_idx = np.empty((16, n), dtype=np.int32)
    a_digits = np.empty((128, n), dtype=np.uint8)
    s_ok = np.empty(n, dtype=np.uint8)
    rc = lib.sm_ed_prep_plain(
        n, np.ascontiguousarray(h_words, dtype=np.uint64),
        np.ascontiguousarray(s_words, dtype=np.uint64),
        b_idx, a_digits, s_ok)
    if rc != 0:
        raise RuntimeError(f"sm_ed_prep_plain failed: {rc}")
    return b_idx, a_digits, s_ok.astype(bool)


def ecdsa_sigs_to_words(sigs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strict-DER ECDSA signatures → (r_words (B,4), s_words (B,4),
    ok (B,) bool), the preps' LE u64 wire format, parsed in one batch.

    The acceptance set is exactly ``ecmath.ecdsa_sig_from_der``'s (tag,
    length, minimality, sign and trailing-byte checks) plus a clamp of
    values >= 2^256. Rejected encodings get ok=False and all-zero rows; r = 0
    fails the preps' range precheck, so the item's verdict is False."""
    n = len(sigs)
    r_rows = np.zeros((n, 32), dtype=np.uint8)
    s_rows = np.zeros((n, 32), dtype=np.uint8)
    ok = np.ones(n, dtype=bool)
    for i, der in enumerate(sigs):
        if len(der) < 8 or der[0] != 0x30 or der[1] != len(der) - 2:
            ok[i] = False
            continue
        idx, bad = 2, False
        for rows in (r_rows, s_rows):
            if idx + 2 > len(der) or der[idx] != 0x02:
                bad = True
                break
            ln = der[idx + 1]
            body = der[idx + 2:idx + 2 + ln]
            if (ln == 0 or len(body) != ln or body[0] & 0x80
                    or (ln > 1 and body[0] == 0 and not (body[1] & 0x80))):
                bad = True
                break
            if body[0] == 0:
                body = body[1:]     # minimal leading zero (sign byte)
            if len(body) > 32:      # >= 2^256: clamp-to-reject
                bad = True
                break
            rows[i, :len(body)] = np.frombuffer(body, dtype=np.uint8)[::-1]
            idx += 2 + ln
        if bad or idx != len(der):
            ok[i] = False
            r_rows[i] = 0
            s_rows[i] = 0
    return r_rows.view("<u8"), s_rows.view("<u8"), ok


def _native():
    lib = _lib()
    if lib is None:
        raise RuntimeError("libscalarmath is not available")
    return lib


def k1_prep(e_words, r_words, s_words, pub_words):
    """secp256k1 hybrid-GLV prep (w = 8). All inputs (B, ·) LE u64 arrays.
    Returns (g_idx (16,B) i32, q_packed (64,B) u8, qc_x, qc_y, qd_x, qd_y
    (B,16) u16, r_limbs (B,16) u16, rn_ok (B,) u8, precheck (B,) bool)."""
    lib = _native()
    n = len(e_words)
    g_idx = np.empty((16, n), dtype=np.int32)
    q_packed = np.empty((64, n), dtype=np.uint8)
    qc_x, qc_y, qd_x, qd_y, r_limbs = (np.empty((n, 16), dtype=np.uint16)
                                       for _ in range(5))
    rn_ok = np.empty(n, dtype=np.uint8)
    precheck = np.empty(n, dtype=np.uint8)
    work = np.empty((3 * n, 4), dtype=np.uint64)
    rc = lib.sm_k1_prep(
        n, np.ascontiguousarray(e_words, dtype=np.uint64),
        np.ascontiguousarray(r_words, dtype=np.uint64),
        np.ascontiguousarray(s_words, dtype=np.uint64),
        np.ascontiguousarray(pub_words, dtype=np.uint64),
        g_idx, q_packed, qc_x, qc_y, qd_x, qd_y, r_limbs,
        rn_ok, precheck, work)
    if rc != 0:
        raise RuntimeError(f"sm_k1_prep failed: {rc}")
    return (g_idx, q_packed, qc_x, qc_y, qd_x, qd_y, r_limbs,
            rn_ok, precheck.astype(bool))


def r1_prep(e_words, r_words, s_words, pub_words):
    """secp256r1 single-scalar windowed prep (w = 16, 4-bit Q digits).
    Returns (g_idx (16,B) i32 w = 16 windows of u1; q_digits (64,B) u8
    4-bit digits of u2; q_x, q_y (B,16) u16 Q; r_limbs (B,16) u16;
    rn_ok (B,) u8 (r + n < p); precheck (B,) bool), all MSB first."""
    lib = _native()
    n = len(e_words)
    g_idx = np.empty((16, n), dtype=np.int32)
    q_digits = np.empty((64, n), dtype=np.uint8)
    q_x, q_y, r_limbs = (np.empty((n, 16), dtype=np.uint16)
                         for _ in range(3))
    rn_ok = np.empty(n, dtype=np.uint8)
    precheck = np.empty(n, dtype=np.uint8)
    work = np.empty((3 * n, 4), dtype=np.uint64)
    rc = lib.sm_r1_prep(
        n, np.ascontiguousarray(e_words, dtype=np.uint64),
        np.ascontiguousarray(r_words, dtype=np.uint64),
        np.ascontiguousarray(s_words, dtype=np.uint64),
        np.ascontiguousarray(pub_words, dtype=np.uint64),
        g_idx, q_digits, q_x, q_y, r_limbs, rn_ok, precheck, work)
    if rc != 0:
        raise RuntimeError(f"sm_r1_prep failed: {rc}")
    return (g_idx, q_digits, q_x, q_y, r_limbs, rn_ok,
            precheck.astype(bool))


def r1_prep_hg(e_words, r_words, s_words, pub_words):
    """secp256r1 half-gcd split prep. Returns (g_idx (16,B) i32 — row 2j
    the t_hi window j, row 2j+1 the t_lo window j; q_digits (32,B) u8 4-bit
    |v1| digits; q_x, q_y (B,16) u16 sign-adjusted Q; xd_limbs (B,16) u16
    x([v2]R); hg_ok (B,) u8; precheck (B,) bool)."""
    lib = _native()
    n = len(e_words)
    g_idx = np.empty((16, n), dtype=np.int32)
    q_digits = np.empty((32, n), dtype=np.uint8)
    q_x, q_y, xd_limbs = (np.empty((n, 16), dtype=np.uint16)
                          for _ in range(3))
    hg_ok = np.empty(n, dtype=np.uint8)
    precheck = np.empty(n, dtype=np.uint8)
    work = np.empty((5 * n, 4), dtype=np.uint64)
    rc = lib.sm_r1_prep_hg(
        n, np.ascontiguousarray(e_words, dtype=np.uint64),
        np.ascontiguousarray(r_words, dtype=np.uint64),
        np.ascontiguousarray(s_words, dtype=np.uint64),
        np.ascontiguousarray(pub_words, dtype=np.uint64),
        g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok, precheck, work)
    if rc != 0:
        raise RuntimeError(f"sm_r1_prep_hg failed: {rc}")
    return (g_idx, q_digits, q_x, q_y, xd_limbs, hg_ok,
            precheck.astype(bool))


#: secp256r1 group order (kept here so this module stays import-light;
#: checked against ecmath.SECP256R1.n by the tests).
R1_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


def r1_halfgcd_py(k: int) -> tuple[bool, int, int] | None:
    """Half-gcd split (Antipa et al., SAC 2005): extended Euclid on (n, k)
    stopped at the first remainder below 2^128. Returns (neg1, v1, v2) with
    k*v2 ≡ (-v1 if neg1 else v1) (mod n), 0 <= v1 < 2^128,
    0 < v2 < 2^128 — bit-identical to the native ``sm_r1_halfgcd`` — or
    None when the split degenerates (k = 0 or k >= n). Signs in the EEA
    t-sequence strictly alternate, so only magnitudes are tracked with one
    parity bit."""
    if k <= 0 or k >= R1_N:
        return None
    r0, r1 = R1_N, k
    m0, m1 = 0, 1
    s_pos = True                     # sign of the t attached to r1
    while r1 >> 128:
        q, rem = divmod(r0, r1)
        r0, r1 = r1, rem
        m0, m1 = m1, m0 + q * m1
        s_pos = not s_pos
    if r1 == 0 or m1 == 0 or (m1 >> 128):
        return None
    return (not s_pos), r1, m1


def r1_halfgcd(k: int) -> tuple[bool, int, int] | None:
    """The native half-gcd split; same contract as :func:`r1_halfgcd_py`."""
    lib = _native()
    kw = ints_to_words([k])
    neg1 = np.zeros(1, dtype=np.uint8)
    v1 = np.zeros(2, dtype=np.uint64)
    v2 = np.zeros(2, dtype=np.uint64)
    if lib.sm_r1_halfgcd(kw, neg1, v1, v2) != 0:
        return None
    return (bool(neg1[0]), int.from_bytes(v1.tobytes(), "little"),
            int.from_bytes(v2.tobytes(), "little"))


# ---------------------------------------------------------------------------
# Test seams: single values through the library's scalar layer
# ---------------------------------------------------------------------------

def mulmod(mod_id: int, a: int, b: int) -> int:
    """a*b mod the modulus ``mod_id`` (MOD_*) by the library's Barrett
    reduction."""
    r = np.zeros((1, 4), dtype=np.uint64)
    rc = _native().sm_mulmod(mod_id, ints_to_words([a]), ints_to_words([b]),
                             r)
    if rc != 0:
        raise RuntimeError(f"sm_mulmod failed: {rc}")
    return int.from_bytes(r.tobytes(), "little")


def mod512(mod_id: int, x: int) -> int:
    """A 512-bit ``x`` reduced mod the modulus ``mod_id``."""
    r = np.zeros((1, 4), dtype=np.uint64)
    rc = _native().sm_mod512(mod_id, ints_to_words([x], nwords=8), r)
    if rc != 0:
        raise RuntimeError(f"sm_mod512 failed: {rc}")
    return int.from_bytes(r.tobytes(), "little")


def glv(k: int) -> tuple[int, int]:
    """secp256k1's GLV split of ``k``: (k1, k2), signed, with
    k ≡ k1 + k2·λ (mod n)."""
    negs = np.zeros(2, dtype=np.uint8)
    a1 = np.zeros(2, dtype=np.uint64)
    a2 = np.zeros(2, dtype=np.uint64)
    rc = _native().sm_glv(ints_to_words([k]), negs, a1, a2)
    if rc != 0:
        raise RuntimeError(f"sm_glv failed: {rc}")
    k1 = int.from_bytes(a1.tobytes(), "little")
    k2 = int.from_bytes(a2.tobytes(), "little")
    return (-k1 if negs[0] else k1), (-k2 if negs[1] else k2)


def r1p_mulfast(a: int, b: int) -> int:
    """a*b mod P-256's prime by the Solinas reduction (the field product
    of the [v2]R ladder in ``sm_r1_prep_hg``)."""
    r = np.zeros((1, 4), dtype=np.uint64)
    rc = _native().sm_r1p_mulfast(ints_to_words([a]), ints_to_words([b]), r)
    if rc != 0:
        raise RuntimeError(f"sm_r1p_mulfast failed: {rc}")
    return int.from_bytes(r.tobytes(), "little")
