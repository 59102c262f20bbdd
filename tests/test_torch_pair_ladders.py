"""One ladder window of the lane-pair formulas of B7 Shamir
(csrc/curve_ed25519_pair.cuh: doublings, a Niels row, a cached row) and of
B5 (csrc/curve_k1_pair.cuh, csrc/curve_p256_pair.cuh through the
K1PairCurve / P256PairCurve traits: doublings, a complete addition, a mixed
addition of an affine G row), built as host C++ and held against Python
integers.

A host thread stands for each lane of a pair and a two-party barrier for
the warp exchange (``__shfl_xor_sync``), so the pair splits its products
between two lanes exactly as on the card; csrc/carry.cuh runs its portable
C++ steps. The build needs only g++.
"""
import ctypes
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest

from corda_tpu_torch.core.crypto import ecmath

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "corda_tpu_torch"
        / "csrc")

STUB = """#pragma once
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <thread>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
struct uint4 { uint32_t x, y, z, w; };
template <class T> inline T __ldg(const T *p) { return *p; }
inline thread_local int g_lane;
inline std::barrier<> *g_pair;
inline uint32_t g_slot[2];
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int) {
  g_slot[g_lane] = v;
  g_pair->arrive_and_wait();
  const uint32_t r = g_slot[g_lane ^ 1];
  g_pair->arrive_and_wait();
  return r;
}
inline void __syncwarp() { g_pair->arrive_and_wait(); }
template <class F> void on_pair(F f) {
  std::barrier<> bar(2);
  g_pair = &bar;
  std::thread even([&] { g_lane = 0; f(false, 0); });
  std::thread odd([&] { g_lane = 1; f(true, 1); });
  even.join();
  odd.join();
}
"""

STEPS = """#include "cuda_stub.h"
#include "curve_k1_pair.cuh"
#include "curve_p256_pair.cuh"
#include "curve_ed25519_pair.cuh"

template <class C>
void ec_window_t(const uint32_t *acc, const uint32_t *row,
                 const uint32_t *g, uint32_t *out) {
  on_pair([&](bool odd, int lane) {
    typename C::pt p, t;
    typename C::fe x2, y2;
    memcpy(&p, acc, 96);
    memcpy(&t, row, 96);
    memcpy(x2.v, g, 32);
    memcpy(y2.v, g + 8, 32);
    for (int d = 0; d < 4; ++d) C::dbl(p, p, odd);
    C::add(p, p, t, odd);
    C::madd(p, p, x2, y2, odd);
    memcpy(out + 24 * lane, &p, 96);
  });
}

extern "C" {
// 4 doublings, the addition of a projective row and the mixed addition of
// an affine G row; each lane's result in out[24 * lane].
void ec_window(int curve, const uint32_t *acc, const uint32_t *row,
               const uint32_t *g, uint32_t *out) {
  if (curve == 0) ec_window_t<K1PairCurve>(acc, row, g, out);
  else ec_window_t<P256PairCurve>(acc, row, g, out);
}
// 4 doublings, a Niels row of B (y + x, y - x, 2dxy) and a cached row
// (Y - X, Y + X, Z, 2dT); each lane's result in out[32 * lane].
void ed_window(const uint32_t *acc, const uint32_t *brow,
               const uint32_t *arow, uint32_t *out) {
  on_pair([&](bool odd, int lane) {
    ge p;
    fe yp, ym, td;
    ge_cached c;
    memcpy(&p, acc, 128);
    memcpy(yp.v, brow, 32);
    memcpy(ym.v, brow + 8, 32);
    memcpy(td.v, brow + 16, 32);
    memcpy(&c, arow, 128);
    for (int d = 0; d < 4; ++d) ge_double_pair(p, p, odd);
    ge_madd_niels_pair(p, yp, ym, td, odd);
    ge_add_cached_pair(p, p, c, odd);
    memcpy(out + 32 * lane, &p, 128);
  });
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("pair_ladders")
    (d / "cuda_stub.h").write_text(STUB)
    (d / "steps.cpp").write_text(STEPS)
    out = d / "libpair_ladders.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-I", str(d), "-I", str(CSRC), "-o", str(out),
                    str(d / "steps.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(out))
    so.ec_window.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    so.ed_window.argtypes = [ctypes.c_void_p] * 4
    return so


def _words(*vals) -> np.ndarray:
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in vals
                     for i in range(8)], dtype=np.uint32)


def _ints(words) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(words[k:k + 8]))
            for k in range(0, len(words), 8)]


def _projective(curve, pt, z):
    """(X, Y, Z) of affine ``pt`` scaled by z; None is (0 : 1 : 0)."""
    if pt is None:
        return 0, 1, 0
    return pt[0] * z % curve.p, pt[1] * z % curve.p, z


@pytest.mark.parametrize("curve_name", ["secp256k1", "secp256r1"])
def test_b5_pair_window_matches_python_integers(lib, curve_name):
    """[16]P + T + G over projective P and T (T the identity (0:1:0) and T
    = -[16]P among them, as T[0] and a cancelling Q row) and an affine G
    row: both lanes end with the same words, the point the host's affine
    group law reaches."""
    curve = ecmath.SECP256K1 if curve_name == "secp256k1" \
        else ecmath.SECP256R1
    rng = random.Random(5)
    for case in range(6):
        P = curve.mul(rng.randrange(1, curve.n), curve.g)
        p16 = curve.mul(16, P)
        T = (None if case == 0 else
             (p16[0], curve.p - p16[1]) if case == 1 else
             curve.mul(rng.randrange(1, curve.n), curve.g))
        G = curve.mul(rng.randrange(1, curve.n), curve.g)
        acc = _words(*_projective(curve, P, rng.randrange(1, curve.p)))
        row = _words(*_projective(curve, T, rng.randrange(1, curve.p)))
        out = np.zeros(48, dtype=np.uint32)
        lib.ec_window(0 if curve_name == "secp256k1" else 1,
                      acc.ctypes.data, row.ctypes.data,
                      _words(*G).ctypes.data, out.ctypes.data)
        assert (out[:24] == out[24:]).all()
        X, Y, Z = (v % curve.p for v in _ints(out[:24]))
        want = curve.add(curve.add(p16, T), G)
        zi = pow(Z, curve.p - 2, curve.p)
        assert (X * zi % curve.p, Y * zi % curve.p) == want, case


def test_b7_pair_window_matches_python_integers(lib):
    """[16]P + [k]B + Q over extended P, a Niels row [k]B (k = 0, the
    identity row, among them) and a cached Q: both lanes end with the same
    words, the point of the host's double-and-add."""
    p = ecmath.ED_P
    base = ecmath.ed_to_extended(ecmath.ED_B)
    rng = random.Random(6)

    def scaled(pt, z):
        x, y = ecmath.ed_to_affine(pt)
        return x * z % p, y * z % p, z, x * y % p * z % p
    for k in (0, 1, 9, 15):
        P = ecmath.ed_scalar_mul(rng.randrange(1, ecmath.ED_L), base)
        Q = ecmath.ed_scalar_mul(rng.randrange(1, ecmath.ED_L), base)
        kb = ecmath.ed_to_affine(ecmath.ed_scalar_mul(k, base)) if k \
            else (0, 1)
        acc = _words(*scaled(P, rng.randrange(1, p)))
        brow = _words((kb[1] + kb[0]) % p, (kb[1] - kb[0]) % p,
                      ecmath.ED_D2 * kb[0] * kb[1] % p)
        qx, qy, qz, qt = scaled(Q, rng.randrange(1, p))
        arow = _words((qy - qx) % p, (qy + qx) % p, qz,
                      ecmath.ED_D2 * qt % p)
        out = np.zeros(64, dtype=np.uint32)
        lib.ed_window(acc.ctypes.data, brow.ctypes.data, arow.ctypes.data,
                      out.ctypes.data)
        assert (out[:32] == out[32:]).all()
        X, Y, Z, T = (v % p for v in _ints(out[:32]))
        want = ecmath.ed_point_add(
            ecmath.ed_point_add(ecmath.ed_scalar_mul(16, P),
                                ecmath.ed_scalar_mul(k, base)), Q)
        assert ecmath.ed_to_affine((X, Y, Z, T)) == ecmath.ed_to_affine(want)
        assert (X * Y - Z * T) % p == 0
