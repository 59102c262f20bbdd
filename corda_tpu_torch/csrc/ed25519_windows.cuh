// Window helpers of the B7 kernels (csrc/ed25519_shamir.cu,
// csrc/ed25519_windowed.cu): the cached form of a point and its addition,
// the addition of a loaded Niels row, and the windowed kernel's base-16
// digits of k.
//
// Replaces, with those kernels, corda_tpu/ops/ed25519.py add and
// madd_niels where an addend is a row of a table. A .cu file includes this
// header at file scope (it brings csrc/curve_ed25519.cuh, the one lane's
// field and formulas) and then csrc/curve_ed25519_pair.cuh inside
// ``namespace pairs``; the templates below take either field's types.
#pragma once
#include <stdint.h>

#include "curve_ed25519.cuh"

// Helpers of the one-lane and the lane-pair kernels, over either field's
// types: the one lane's (csrc/curve_ed25519.cuh) or the pairs' (namespace
// pairs); argument-dependent lookup picks that field's fe_add, fe_mul,
// fe_canon.

// The cached identity (1, 1, 1, 0).
template <class GC>
__device__ __forceinline__ void ge_cached_identity(GC &o) {
  fe_one(o.ymx);
  fe_one(o.ypx);
  fe_one(o.Z);
  fe_zero(o.T2d);
}

// p in cached form (on both lanes of a pair): 1 product. Both fields keep
// 2d in the same words, FE_D2.
template <class GC, class GE>
__device__ __forceinline__ void ge_to_cached(GC &o, const GE &p) {
  auto d2 = p.T;
#pragma unroll
  for (int k = 0; k < 8; ++k) d2.v[k] = FE_D2[k];
  fe_sub(o.ymx, p.Y, p.X);
  fe_add(o.ypx, p.Y, p.X);
  o.Z = p.Z;
  fe_mul(o.T2d, p.T, d2);
}

// B's Niels row ``digit`` (y + x, y - x, 2dxy) from shared memory.
template <class FE>
__device__ __forceinline__ void load_b_row(FE &yp, FE &ym, FE &td,
                                           const uint32_t *rows, int digit) {
  const uint32_t *r = rows + digit * 24;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    yp.v[k] = r[k];
    ym.v[k] = r[8 + k];
    td.v[k] = r[16 + k];
  }
}

template <class FE>
__device__ __forceinline__ bool fe_equal_canon(const FE &a, const FE &b) {
  FE ca, cb;
  fe_canon(ca, a);
  fe_canon(cb, b);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= ca.v[k] ^ cb.v[k];
  return diff == 0;
}

// -- one lane a signature: csrc/curve_ed25519.cuh's field and formulas ---
// The formulas below that csrc/curve_ed25519.cuh lacks live here, so that
// B2's one-lane kernel, which includes that header alone, keeps building
// from unchanged sources.

// A point in cached form (Y - X, Y + X, Z, 2d T): the addend of
// ge_add_cached, whose T1 2d T2 is then one product.
struct ge_cached {
  fe ymx, ypx, Z, T2d;
};

// ge_add with a cached addend: 8 products.
__device__ __noinline__ void ge_add_cached(ge &o, const ge &p,
                                           const ge_cached &q) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.T2d);
  fe_mul(d, p.Z, q.Z);
  fe_mul_small(d, d, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(o.X, e, f);
  fe_mul(o.Y, g, h);
  fe_mul(o.Z, f, g);
  fe_mul(o.T, e, h);
}

// ge_madd_niels on a Niels row (y + x, y - x, 2dxy) already loaded: 7
// products.
__device__ __noinline__ void ge_madd_row(ge &acc, const fe &yp, const fe &ym,
                                         const fe &td) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, acc.Y, acc.X);
  fe_mul(a, a, ym);
  fe_add(b, acc.Y, acc.X);
  fe_mul(b, b, yp);
  fe_mul(c, acc.T, td);
  fe_mul_small(d, acc.Z, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(acc.X, e, f);
  fe_mul(acc.Y, g, h);
  fe_mul(acc.Z, f, g);
  fe_mul(acc.T, e, h);
}

// Digit w (0..63, most significant first) of k in base 16 from the
// windowed kernel's wire: the 2-bit digits 2w and 2w + 1 of
// a_digits (16, 8, n), the first the high half.
__device__ __forceinline__ int a_window_digit(const uint8_t *a_digits, int w,
                                              int64_t n, int64_t i) {
  const uint8_t *p = a_digits + (int64_t)(2 * w) * n + i;
  return ((p[0] & 3) << 2) | (p[n] & 3);
}
