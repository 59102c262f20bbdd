// Extended-coordinate edwards25519 formulas over a lane pair, for the
// pair kernels of B2 (csrc/ed25519_split.cu) and B7 Shamir
// (csrc/ed25519_shamir.cu), on the Comba field csrc/field25519_comba.cuh.
//
// Replaces corda_tpu/ops/ed25519.py add, double and madd_niels (the JAX
// kernels' point formulas), as csrc/curve_ed25519.cuh does for one thread:
// each formula computes that file's field values step for step (the cached
// addition those of ge_add_cached in csrc/ed25519_shamir.cu), and only
// which lane computes a product changes (csrc/lanes.cuh). An addition runs
// 2 + 1 + 2 products deep (the one T1 2d T2 step runs on both lanes), a
// doubling 2 + 2, a Niels addition 2 + 2 (T td on both lanes), an
// addition of a cached addend (Y - X, Y + X, Z, 2dT) 2 + 2. The
// formulas are complete on edwards25519 (a = -1 square, d non-square), so
// no kernel branches on the data.
//
// B2 and B7 Shamir include this header inside ``namespace pairs``: its
// field and point types are the Comba field's, apart from the one-lane
// kernels' in csrc/curve_ed25519.cuh.
#pragma once
#include <stdint.h>

#include "field25519_comba.cuh"
#include "lanes.cuh"

struct ge {
  fe X, Y, Z, T;
};

__device__ __forceinline__ void ge_identity(ge &o) {
  fe_zero(o.X);
  fe_one(o.Y);
  fe_one(o.Z);
  fe_zero(o.T);
}

__device__ __forceinline__ void fe_load16(fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

struct Field25519 {
  typedef fe elem;
  static __device__ __forceinline__ void mul(elem &o, const elem &a,
                                             const elem &b) {
    fe_mul(o, a, b);
  }
  static __device__ __forceinline__ void sqr(elem &o, const elem &a) {
    fe_sqr(o, a);
  }
};

// The last layer of all three: X = e f, Y = g h | Z = f g, T = e h.
__device__ __forceinline__ void ge_tail_pair(ge &o, const fe &e, const fe &f,
                                             const fe &g, const fe &h,
                                             bool odd) {
  fe X, Y;
  pair_mul<Field25519>(X, Y, e, f, g, h, odd);
  pair_mul<Field25519>(o.Z, o.T, f, g, e, h, odd);
  o.X = X;
  o.Y = Y;
}

// ge_add over a lane pair.
__device__ __forceinline__ void ge_add_pair(ge &o, const ge &p, const ge &q,
                                            bool odd) {
  fe a, b, c, d, e, f, g, h, u, v, d2;
  // (Y1 - X1)(Y2 - X2) | (Y1 + X1)(Y2 + X2), T1 2d | Z1 Z2
  fe_sub(a, p.Y, p.X);
  fe_add(b, p.Y, p.X);
  fe_pick(u, odd, b, a);
  fe_sub(a, q.Y, q.X);
  fe_add(b, q.Y, q.X);
  fe_pick(v, odd, b, a);
  pair_mul<Field25519>(a, b, u, v, u, v, odd);
#pragma unroll
  for (int i = 0; i < 8; ++i) d2.v[i] = FE_D2[i];
  pair_mul<Field25519>(c, d, p.T, d2, p.Z, q.Z, odd);
  fe_mul(c, c, q.T);
  fe_mul_small(d, d, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  ge_tail_pair(o, e, f, g, h, odd);
}

// A point in cached form (Y - X, Y + X, Z, 2d T): the addend of
// ge_add_cached_pair, whose T1 2d T2 is then one product.
struct ge_cached {
  fe ymx, ypx, Z, T2d;
};

// ge_add with a cached addend over a lane pair: (Y1 - X1)(Y2 - X2) |
// (Y1 + X1)(Y2 + X2), T1 2dT2 | Z1 Z2, then the tail: 4 products deep,
// none of them on both lanes.
__device__ __forceinline__ void ge_add_cached_pair(ge &o, const ge &p,
                                                   const ge_cached &q,
                                                   bool odd) {
  fe a, b, c, d, e, f, g, h, u, v;
  fe_sub(a, p.Y, p.X);
  fe_add(b, p.Y, p.X);
  fe_pick(u, odd, b, a);
  fe_pick(v, odd, q.ypx, q.ymx);
  pair_mul<Field25519>(a, b, u, v, u, v, odd);
  pair_mul<Field25519>(c, d, p.T, q.T2d, p.Z, q.Z, odd);
  fe_mul_small(d, d, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  ge_tail_pair(o, e, f, g, h, odd);
}

// ge_double over a lane pair.
__device__ __forceinline__ void ge_double_pair(ge &o, const ge &p, bool odd) {
  fe a, b, c, e, f, g, h, t;
  // X^2 | Y^2, Z^2 | (X + Y)^2
  pair_sqr<Field25519>(a, b, p.X, p.Y, odd);
  fe_add(t, p.X, p.Y);
  pair_sqr<Field25519>(c, t, p.Z, t, odd);
  fe_mul_small(c, c, 2);
  fe_add(h, a, b);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  ge_tail_pair(o, e, f, g, h, odd);
}

// ge_madd_niels over a lane pair, on a Niels row (y+x, y-x, 2dxy) already
// loaded.
__device__ __forceinline__ void ge_madd_niels_pair(ge &acc, const fe &yp,
                                                   const fe &ym,
                                                   const fe &td, bool odd) {
  fe a, b, c, d, e, f, g, h, u;
  // (Y - X) ym | (Y + X) yp, then T td on both lanes
  fe_sub(a, acc.Y, acc.X);
  fe_add(b, acc.Y, acc.X);
  fe_pick(u, odd, b, a);
  fe_pick(c, odd, yp, ym);
  pair_mul<Field25519>(a, b, u, c, u, c, odd);
  fe_mul(c, acc.T, td);
  fe_mul_small(d, acc.Z, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  ge_tail_pair(acc, e, f, g, h, odd);
}
