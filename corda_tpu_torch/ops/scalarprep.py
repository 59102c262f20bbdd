"""ctypes binding of native/scalarmath.cpp — batch host scalar prep.

Port of corda_tpu/ops/scalarprep.py for the Ed25519 slice. The C library
does the per-item scalar layer of Ed25519 split-k verification (reduction of
the SHA-512 challenge mod L, the s < L range check, window and joint-digit
extraction) in one pass per batch. It is built from the repository's
``native/scalarmath.cpp`` with g++ into ``corda_tpu_torch/_build/`` the
first time it is needed (``_build.load``); ``native/`` itself is untouched.

When no compiler is present, or the built library reports another ABI
version, ``available()`` is False and callers use the bit-identical Python
prep (``ed25519._split_windows_python``), with a warning: it is an order of
magnitude slower.

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
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")

_LOCK = threading.Lock()
_STATE: dict = {}


def _bind(lib) -> None:
    lib.sm_ed_prep.restype = ctypes.c_int
    lib.sm_ed_prep.argtypes = [
        ctypes.c_int64, _U64P, _U64P, _I32P, _I32P, _U8P, _U8P]


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


def available() -> bool:
    """True when the native prep is built and has the expected ABI."""
    return _lib() is not None


def ints_to_words(xs, nwords: int = 4) -> np.ndarray:
    """Python ints → (B, nwords) LE u64 array (one C-level to_bytes each)."""
    nbytes = nwords * 8
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), nwords).copy()


def le_digests_to_words(digests: list[bytes], nwords: int) -> np.ndarray:
    """Little-endian-integer digests (RFC 8032 SHA-512) → LE u64 words."""
    buf = b"".join(digests)
    return np.frombuffer(buf, dtype="<u8").reshape(
        len(digests), nwords).copy()


def ed_prep(h_words, s_words):
    """Ed25519 split-k prep: (B, 8) SHA-512 digest words and (B, 4) s words
    → (b_idx(8,B), b2_idx(8,B) i32, a_packed(64,B) u8, s_ok(B) bool)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libscalarmath is not available")
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
