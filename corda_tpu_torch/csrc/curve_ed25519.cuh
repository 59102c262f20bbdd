// Extended-coordinate edwards25519 point arithmetic for Hopper device code.
//
// Replaces corda_tpu/ops/ed25519.py identity, add, double and madd_niels
// (the JAX kernels' point formulas), shared by the Ed25519 kernels: B2
// (ed25519_split.cu) and B7 (ed25519_shamir.cu, ed25519_windowed.cu). The
// formulas are complete on edwards25519 (a = -1 square, d non-square), so no
// kernel branches on the data. Field arithmetic: field25519.cuh.
#pragma once
#include <stdint.h>

#include "field25519.cuh"

struct ge {
  fe X, Y, Z, T;
};

__device__ __forceinline__ void ge_identity(ge &o) {
  fe_zero(o.X);
  fe_one(o.Y);
  fe_one(o.Z);
  fe_zero(o.T);
}

// Unified extended addition (add-2008-hwcd-3, a = -1, k = 2d): 9 products.
__device__ __noinline__ void ge_add(ge &o, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, b, t);
  fe d2;
#pragma unroll
  for (int i = 0; i < 8; ++i) d2.v[i] = FE_D2[i];
  fe_mul(c, p.T, d2);
  fe_mul(c, c, q.T);
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

// Doubling (dbl-2008-hwcd): 4 squarings + 4 products.
__device__ __noinline__ void ge_double(ge &o, const ge &p) {
  fe a, b, c, e, f, g, h, t;
  fe_sqr(a, p.X);
  fe_sqr(b, p.Y);
  fe_sqr(c, p.Z);
  fe_mul_small(c, c, 2);
  fe_add(h, a, b);
  fe_add(t, p.X, p.Y);
  fe_sqr(t, t);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(o.X, e, f);
  fe_mul(o.Y, g, h);
  fe_mul(o.Z, f, g);
  fe_mul(o.T, e, h);
}

__device__ __forceinline__ void fe_load16(fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

// Mixed addition of the Niels row (y+x, y-x, 2dxy) of a constant table,
// Z2 = 1: 7 products. Complete for every accumulator; row 0 is (1, 1, 0).
__device__ __noinline__ void ge_madd_niels(ge &acc, const uint16_t *tp,
                                           const uint16_t *tm,
                                           const uint16_t *ttd, int row) {
  fe yp, ym, td, a, b, c, d, e, f, g, h;
  const int64_t off = (int64_t)(row & 0xFFFF) * 16;
  fe_load16(yp, tp + off);
  fe_load16(ym, tm + off);
  fe_load16(td, ttd + off);
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
