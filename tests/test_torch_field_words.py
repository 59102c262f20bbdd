"""The word arithmetic of the lane-pair kernels' Comba fields
(csrc/field25519_comba.cuh, csrc/field_p256_comba.cuh,
csrc/field_k1_comba.cuh over csrc/carry.cuh)
built as host C++ and held against Python integers: the reductions, folds
and chain bookkeeping are the same code on the card, where csrc/carry.cuh
swaps each plain C++ step for its one PTX carry-chain statement.

The build needs only g++ (the compiler that builds native/scalarmath.cpp);
a few stub macros stand in for CUDA's qualifiers.
"""
import ctypes
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "corda_tpu_torch"
        / "csrc")
P256 = 2**256 - 2**224 + 2**192 + 2**96 - 1
PK1 = 2**256 - 2**32 - 977
P25519 = 2**255 - 19
M = 2**256

STUB = """#pragma once
#include <stdint.h>
#include <string.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
"""

OPS = """#include "cuda_stub.h"
#include "field_p256_comba.cuh"
#include "field25519_comba.cuh"
#include "field_k1_comba.cuh"
extern "C" {
void k1_op(int op, const uint32_t *a, const uint32_t *b, uint32_t *o) {
  k1fe x, y, r;
  memcpy(x.v, a, 32);
  memcpy(y.v, b, 32);
  if (op == 0) k1_mul(r, x, y);
  else if (op == 1) k1_sqr(r, x);
  else if (op == 2) k1_add(r, x, y);
  else if (op == 3) k1_sub(r, x, y);
  else if (op == 4) k1_mul_small(r, x, 21);
  else k1_canon(r, x);
  memcpy(o, r.v, 32);
}
void p256_op(int op, const uint32_t *a, const uint32_t *b, uint32_t *o) {
  p256fe x, y, r;
  memcpy(x.v, a, 32);
  memcpy(y.v, b, 32);
  if (op == 0) p256_mul(r, x, y);
  else if (op == 1) p256_sqr(r, x);
  else if (op == 2) p256_add(r, x, y);
  else p256_sub(r, x, y);
  memcpy(o, r.v, 32);
}
void fe_op(int op, const uint32_t *a, const uint32_t *b, uint32_t *o) {
  fe x, y, r;
  memcpy(x.v, a, 32);
  memcpy(y.v, b, 32);
  if (op == 0) fe_mul(r, x, y);
  else if (op == 1) fe_sqr(r, x);
  else if (op == 2) fe_add(r, x, y);
  else if (op == 3) fe_sub(r, x, y);
  else if (op == 4) fe_mul_small(r, x, 2);
  else fe_inv(r, x);
  memcpy(o, r.v, 32);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("field_words")
    (d / "cuda_stub.h").write_text(STUB)
    (d / "ops.cpp").write_text(OPS)
    out = d / "libfield_words.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    "-I", str(CSRC), "-o", str(out), str(d / "ops.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(out))
    for fn in (so.p256_op, so.fe_op, so.k1_op):
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    return so


def _words(x):
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                    dtype=np.uint32)


def _call(fn, op, a, b=0):
    x, y, o = _words(a), _words(b), np.zeros(8, dtype=np.uint32)
    fn(op, x.ctypes.data, y.ctypes.data, o.ctypes.data)
    return sum(int(w) << (32 * i) for i, w in enumerate(o))


def _values(p, seed):
    rng = random.Random(seed)
    edges = [0, 1, 2, 37, 38, p - 1, p, p + 1, 2 * p - 1 if 2 * p < M else 5,
             M - 1, M - 2, M - 38, M - p, 2**224, 2**255, 2**128 - 1,
             2**32 - 1, P256, P25519, M - p - 1, M - 2**32, PK1]
    return edges + [rng.randrange(M) for _ in range(40)]


FIELDS = {"p256": (P256, "p256_op"), "p25519": (P25519, "fe_op"),
          "secp256k1": (PK1, "k1_op")}


@pytest.mark.parametrize("field", ["p256", "p25519", "secp256k1"])
def test_field_words_match_python_integers(lib, field):
    """mul, sqr, add and sub on edge values (0, p - 1, p, inputs in
    [p, 2^256), 2^256 - 1 with every word all ones, 2^256 - p, ...) and
    random 256-bit words: every result lies in [0, 2^256) and is congruent
    to the exact integer result mod p."""
    p, name = FIELDS[field]
    fn = getattr(lib, name)
    vals = _values(p, 7)
    for a in vals:
        for b in vals[:19] + vals[-6:]:
            for op, want in ((0, a * b), (2, a + b), (3, a - b)):
                got = _call(fn, op, a, b)
                assert got < M and (got - want) % p == 0, (op, a, b)
        got = _call(fn, 1, a)
        assert got < M and (got - a * a) % p == 0, a


def test_p25519_small_product_and_inverse_match_python_integers(lib):
    """fe_mul_small (by 2, as the point formulas use it) and the Fermat
    inverse (0 maps to 0)."""
    for a in _values(P25519, 11):
        got = _call(lib.fe_op, 4, a)
        assert got < M and (got - 2 * a) % P25519 == 0
        got = _call(lib.fe_op, 5, a)
        assert got < M and (got - pow(a, P25519 - 2, P25519)) % P25519 == 0


def test_secp256k1_fold_small_product_and_canon_match_python_integers(lib):
    """secp256k1: products whose fold carries out of the top word (both
    factors near 2^256, so 977 H + 2^32 H passes 2^256 and the top word
    itself wraps), k1_mul_small by b3 = 21, and k1_canon, which alone
    reduces below p (inputs in [p, 2^256) included)."""
    tops = [M - 1, M - 2, M - 2**32 - 1, PK1 + 5, M - 977]
    for a in tops:
        for b in tops:
            got = _call(lib.k1_op, 0, a, b)
            assert got < M and (got - a * b) % PK1 == 0, (a, b)
    for a in _values(PK1, 13) + tops:
        got = _call(lib.k1_op, 4, a)
        assert got < M and (got - 21 * a) % PK1 == 0, a
        assert _call(lib.k1_op, 5, a) == a % PK1, a
