"""One ladder window of the lane-pair formulas of B7 Shamir
(csrc/curve_ed25519_pair.cuh: doublings, a Niels row, a cached row), of
B5 (csrc/curve_k1_pair.cuh, csrc/curve_p256_pair.cuh through the
K1PairCurve / P256PairCurve traits: doublings, a complete addition, a mixed
addition of an affine G row), one step of B8 GLV (a doubling, a row of a
table split between the lanes, a complete addition) and one of B7 windowed
(two 4-bit windows of k joined from the wire's 2-bit digits over a split
cached -A table, then a Niels row of B fetched by pair_fetch_row3), built
as host C++ and held against Python integers.

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
// A doubling, row ``idx`` of a 16-row table (rows: 24 words a row) split
// between the lanes and a complete addition, B8 GLV's step; each lane's
// result in out[24 * lane].
void glv_step(const uint32_t *acc, const uint32_t *rows, int idx,
              uint32_t *out) {
  on_pair([&](bool odd, int lane) {
    k1pt p, a, T[8];
    memcpy(&p, acc, 96);
    for (int k = 0; k < 16; ++k) {
      memcpy(&a, rows + 24 * k, 96);
      pair_row_put(T, k, a, odd);
    }
    k1pt_dbl_pair(p, p, odd);
    pair_row_get(a, T, idx, odd);
    k1pt_add_pair(p, p, a, odd);
    memcpy(out + 24 * lane, &p, 96);
  });
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


# B7 windowed's helpers come with the one lane's field
# (csrc/ed25519_windows.cuh), so its step is a translation unit of its own,
# laid out as the kernel's: the pair header inside ``namespace pairs``.
WINDOWED_STEP = """#include "cuda_stub.h"
#include "ed25519_windows.cuh"
namespace pairs {
#include "curve_ed25519_pair.cuh"

void windowed_step(const uint32_t *acc, const uint32_t *arows,
                   const uint8_t *a_digits, int64_t n, int64_t i, int w0,
                   const uint16_t *tp, const uint16_t *tm,
                   const uint16_t *ttd, int32_t row, uint32_t *out) {
  uint4 rows[6];  // the pair's shared memory
  on_pair([&](bool odd, int lane) {
    ge p;
    ge_cached T[8], c;
    memcpy(&p, acc, 128);
    for (int k = 0; k < 16; ++k) {
      memcpy(&c, arows + 32 * k, 128);
      pair_row_put(T, k, c, odd);
    }
    pair_fetch_row3(rows, tp, tm, ttd, row, odd);
    for (int w = w0; w < w0 + 2; ++w) {
      for (int d = 0; d < 4; ++d) ge_double_pair(p, p, odd);
      pair_row_get(c, T, a_window_digit(a_digits, w, n, i), odd);
      ge_add_cached_pair(p, p, c, odd);
    }
    cp_async_wait_all();
    __syncwarp();
    fe yp, ym, td;
    row_fe(yp, rows);
    row_fe(ym, rows + 2);
    row_fe(td, rows + 4);
    ge_madd_niels_pair(p, yp, ym, td, odd);
    memcpy(out + 32 * lane, &p, 128);
  });
}
}  // namespace pairs

extern "C" {
// Windows w0 and w0 + 1 of item i of a_digits (16, 8, n): each 4
// doublings and the cached row [k_w](-A) of arows (16 rows of 32 words,
// split between the lanes), then B's Niels row ``row`` of (tp, tm, ttd);
// each lane's result in out[32 * lane].
void windowed_step(const uint32_t *acc, const uint32_t *arows,
                   const uint8_t *a_digits, int64_t n, int64_t i, int w0,
                   const uint16_t *tp, const uint16_t *tm,
                   const uint16_t *ttd, int32_t row, uint32_t *out) {
  pairs::windowed_step(acc, arows, a_digits, n, i, w0, tp, tm, ttd, row,
                       out);
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
    builds = []
    for name, text in (("steps", STEPS), ("windowed", WINDOWED_STEP)):
        (d / f"{name}.cpp").write_text(text)
        out = d / f"lib{name}.so"
        builds.append((out, subprocess.Popen(
            [cxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
             "-I", str(d), "-I", str(CSRC), "-o", str(out),
             str(d / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for out, proc in builds:
        assert proc.wait(timeout=120) == 0, proc.stdout.read().decode()
    so = ctypes.CDLL(str(builds[0][0]))
    so.ec_window.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    so.ed_window.argtypes = [ctypes.c_void_p] * 4
    so.glv_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p]
    so.windowed = ctypes.CDLL(str(builds[1][0]))
    so.windowed.windowed_step.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int32, ctypes.c_void_p])
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


def test_b8_glv_pair_step_matches_python_integers(lib):
    """2P + T[idx] over a projective P and a 16-row table of projective
    points split between the lanes (the identity (0:1:0) as T[0], a row
    equal to -2P among them): both lanes end with the same words, the point
    of the host's affine group law."""
    curve = ecmath.SECP256K1
    rng = random.Random(8)
    for case, idx in enumerate((0, 3, 8, 15, 9)):
        P = curve.mul(rng.randrange(1, curve.n), curve.g)
        rows = [None] + [curve.mul(rng.randrange(1, curve.n), curve.g)
                         for _ in range(15)]
        if case == 4:
            p2 = curve.mul(2, P)
            rows[idx] = (p2[0], curve.p - p2[1])
        table = np.concatenate([
            _words(*_projective(curve, pt, rng.randrange(1, curve.p)))
            for pt in rows])
        acc = _words(*_projective(curve, P, rng.randrange(1, curve.p)))
        out = np.zeros(48, dtype=np.uint32)
        lib.glv_step(acc.ctypes.data, table.ctypes.data, idx,
                     out.ctypes.data)
        assert (out[:24] == out[24:]).all()
        X, Y, Z = (v % curve.p for v in _ints(out[:24]))
        want = curve.add(curve.mul(2, P), rows[idx])
        if want is None:
            assert Z == 0 and X == 0, case
            continue
        zi = pow(Z, curve.p - 2, curve.p)
        assert (X * zi % curve.p, Y * zi % curve.p) == want, case


def test_b7_windowed_pair_step_matches_python_integers(lib):
    """[256]P + [16 k_w + k_(w+1)](-A) + [j]B from a_digits laid out as
    the wire's (16, 8, n): the kernel joins 2-bit digits 2w and 2w + 1 into
    k_w, takes the cached rows of a table split between the lanes, and
    fetches B's Niels row j (j = 0, the identity row, among them) from
    three coordinate tables; both lanes end with the same words, the
    point of the host's double-and-add."""
    p = ecmath.ED_P
    base = ecmath.ed_to_extended(ecmath.ED_B)
    rng = random.Random(9)

    def scaled(pt, z):
        x, y = ecmath.ed_to_affine(pt)
        return x * z % p, y * z % p, z, x * y % p * z % p
    n, n_rows = 3, 4
    for case in range(4):
        P = ecmath.ed_scalar_mul(rng.randrange(1, ecmath.ED_L), base)
        A = ecmath.ed_scalar_mul(rng.randrange(1, ecmath.ED_L), base)
        arows = []
        for k in range(16):
            x, y, z, t = scaled(ecmath.ed_scalar_mul(k, A),
                                rng.randrange(1, p))
            arows.append(_words((y - x) % p, (y + x) % p, z,
                                ecmath.ED_D2 * t % p))
        digits = np.array([rng.randrange(4) for _ in range(128 * n)],
                          dtype=np.uint8).reshape(16, 8, n)
        i, w0 = case % n, rng.randrange(63)
        flat = digits.reshape(128, n)[:, i]
        k_w = [4 * int(flat[2 * w]) + int(flat[2 * w + 1])
               for w in (w0, w0 + 1)]
        js = [0] + [rng.randrange(1, 1 << 16) for _ in range(n_rows - 1)]
        tabs = np.zeros((3, n_rows, 16), dtype=np.uint16)
        for r, j in enumerate(js):
            bx, by = ecmath.ed_to_affine(ecmath.ed_scalar_mul(j, base)) \
                if j else (0, 1)
            for c, v in enumerate(((by + bx) % p, (by - bx) % p,
                                   ecmath.ED_D2 * bx * by % p)):
                tabs[c, r] = [(v >> (16 * q)) & 0xFFFF for q in range(16)]
        row = case % n_rows
        acc = _words(*scaled(P, rng.randrange(1, p)))
        out = np.zeros(64, dtype=np.uint32)
        lib.windowed.windowed_step(
            acc.ctypes.data, np.concatenate(arows).ctypes.data,
            digits.ctypes.data, n, i, w0, tabs[0].ctypes.data,
            tabs[1].ctypes.data, tabs[2].ctypes.data, row, out.ctypes.data)
        assert (out[:32] == out[32:]).all()
        X, Y, Z, T = (v % p for v in _ints(out[:32]))
        want = ecmath.ed_point_add(
            ecmath.ed_point_add(ecmath.ed_scalar_mul(256, P),
                                ecmath.ed_scalar_mul(16 * k_w[0] + k_w[1],
                                                     A)),
            ecmath.ed_scalar_mul(js[row], base))
        assert ecmath.ed_to_affine((X, Y, Z, T)) == ecmath.ed_to_affine(want)
        assert (X * Y - Z * T) % p == 0
