// Projective secp256k1 formulas over a lane pair, for the pair kernels of
// B3 (csrc/secp256k1_hybrid.cu) and B8 (csrc/weierstrass_shamir.cu), on
// the Comba field csrc/field_k1_comba.cuh: the complete a = 0 formulas of
// Renes-Costello-Batina 2016 (Algorithms 7, 8 and 9, b3 = 21).
//
// Replaces the a = 0 branches of corda_tpu/ops/weierstrass.py add, dbl
// and _madd_w (with _add_k1, _madd_k1 and _dbl_k1), as csrc/curve_k1.cuh
// does for one thread: each formula computes that file's field values
// step for step, and only which lane computes a product changes
// (csrc/lanes.cuh). An addition has two layers of independent products
// (6 and 6, or 5 and 6 for the mixed one) and a doubling two of 4, so a
// pair runs an addition 6 products deep where one thread runs 12 (11
// mixed) and a doubling 4 where one thread runs 8. The products by
// b3 = 21 are small-constant multiplies on both lanes. The identity is
// (0:1:0); the mixed addition is not valid for an identity addend (the
// kernels keep the accumulator on flag-0 rows).
//
// Its field and point types take the names of the one-thread kernels'
// (csrc/curve_k1.cuh); no translation unit includes both headers.
#pragma once
#include <stdint.h>

#include "field_k1_comba.cuh"
#include "lanes.cuh"

// The generator G, little-endian words.
__device__ __constant__ uint32_t K1_GX[8] = {
    0x16f81798u, 0x59f2815bu, 0x2dce28d9u, 0x029bfcdbu,
    0xce870b07u, 0x55a06295u, 0xf9dcbbacu, 0x79be667eu};
__device__ __constant__ uint32_t K1_GY[8] = {
    0xfb10d4b8u, 0x9c47d08fu, 0xa6855419u, 0xfd17b448u,
    0x0e1108a8u, 0x5da4fbfcu, 0x26a3c465u, 0x483ada77u};

struct k1pt {
  k1fe X, Y, Z;
};

#define K1_B3 21u  // 3 * b, b = 7

__device__ __forceinline__ void k1pt_identity(k1pt &o) {
  k1_zero(o.X);
  k1_one(o.Y);
  k1_zero(o.Z);
}

__device__ __forceinline__ void k1_load16(k1fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

struct K1Field {
  typedef k1fe elem;
  static __device__ __forceinline__ void mul(elem &o, const elem &a,
                                             const elem &b) {
    k1_mul(o, a, b);
  }
  static __device__ __forceinline__ void sqr(elem &o, const elem &a) {
    k1_sqr(o, a);
  }
};

// The last layer shared by Algorithms 7 and 8: X = t3 t1 - t4 y3,
// Y = t1 z3 + y3 t0, Z = z3 t4 + t0 t3; the even lane computes the first
// product of each, the odd lane the second.
__device__ __forceinline__ void k1_tail_pair(k1pt &o, const k1fe &t0,
                                             const k1fe &t1, const k1fe &t3,
                                             const k1fe &t4, const k1fe &y3,
                                             const k1fe &z3, bool odd) {
  k1fe u, v, m, w, X;
  fe_pick(u, odd, t4, t3);
  fe_pick(v, odd, y3, t1);
  k1_mul(m, u, v);
  pair_other(w, m);
  fe_pick(u, odd, w, m);
  fe_pick(v, odd, m, w);
  k1_sub(X, u, v);
  fe_pick(u, odd, y3, t1);
  fe_pick(v, odd, t0, z3);
  k1_mul(m, u, v);
  pair_other(w, m);
  k1_add(o.Y, m, w);
  fe_pick(u, odd, t0, z3);
  fe_pick(v, odd, t3, t4);
  k1_mul(m, u, v);
  pair_other(w, m);
  k1_add(o.Z, m, w);
  o.X = X;
}

// The additions between the two layers shared by Algorithms 7 and 8:
// t0 = 3 t0, t2 = b3 t2, z3 = t1 + t2, t1 = t1 - t2, y3 = b3 y3.
__device__ __forceinline__ void k1_mid(k1fe &t0, k1fe &t1, k1fe &t2,
                                       k1fe &y3, k1fe &z3) {
  k1fe x3;
  k1_add(x3, t0, t0);
  k1_add(t0, x3, t0);
  k1_mul_small(t2, t2, K1_B3);
  k1_add(z3, t1, t2);
  k1_sub(t1, t1, t2);
  k1_mul_small(y3, y3, K1_B3);
}

// Algorithm 7 over a lane pair (k1pt_add's values).
__device__ __forceinline__ void k1pt_add_pair(k1pt &o, const k1pt &p,
                                              const k1pt &q, bool odd) {
  k1fe t0, t1, t2, t3, t4, x3, y3, z3, u, v, m;
  // X1 X2 | Y1 Y2, Z1 Z2 | (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2) |
  // (X1 + Z1)(X2 + Z2)
  pair_mul<K1Field>(t0, t1, p.X, q.X, p.Y, q.Y, odd);
  k1_add(u, p.X, p.Y);
  k1_add(v, q.X, q.Y);
  pair_mul<K1Field>(t2, t3, p.Z, q.Z, u, v, odd);
  fe_pick(u, odd, p.X, p.Y);
  fe_pick(v, odd, q.X, q.Y);
  k1_add(u, u, p.Z);
  k1_add(v, v, q.Z);
  k1_mul(m, u, v);
  pair_share(t4, x3, m, odd);
  k1_add(u, t0, t1);
  k1_sub(t3, t3, u);
  k1_add(u, t1, t2);
  k1_sub(t4, t4, u);
  k1_add(y3, t0, t2);
  k1_sub(y3, x3, y3);
  k1_mid(t0, t1, t2, y3, z3);
  k1_tail_pair(o, t0, t1, t3, t4, y3, z3, odd);
}

// Algorithm 8 over a lane pair (k1pt_madd's values): the affine addend
// (x2, y2) has Z2 = 1.
__device__ __forceinline__ void k1pt_madd_pair(k1pt &o, const k1pt &p,
                                               const k1fe &x2,
                                               const k1fe &y2, bool odd) {
  k1fe t0, t1, t2, t3, t4, y3, z3, u, v;
  // X1 x2 | Y1 y2, y2 Z1 | x2 Z1, then (x2 + y2)(X1 + Y1) on both lanes
  pair_mul<K1Field>(t0, t1, p.X, x2, p.Y, y2, odd);
  fe_pick(u, odd, x2, y2);
  pair_mul<K1Field>(t4, y3, u, p.Z, u, p.Z, odd);
  k1_add(u, x2, y2);
  k1_add(v, p.X, p.Y);
  k1_mul(t3, u, v);
  k1_add(u, t0, t1);
  k1_sub(t3, t3, u);
  k1_add(t4, t4, p.Y);
  k1_add(y3, y3, p.X);
  t2 = p.Z;
  k1_mid(t0, t1, t2, y3, z3);
  k1_tail_pair(o, t0, t1, t3, t4, y3, z3, odd);
}

// Algorithm 9 over a lane pair (k1pt_dbl's values): X = 2 t0 XY,
// Y = t2 z3 + t0 (Y^2 + t2), Z = YZ z3, with z3 = 8 Y^2, t2 = b3 Z^2 and
// t0 = Y^2 - 3 t2.
__device__ __forceinline__ void k1pt_dbl_pair(k1pt &o, const k1pt &p,
                                              bool odd) {
  k1fe t0, t1, t2, y3, z3, xy, u, v, m, w;
  // Y^2 | Z^2, Y Z | X Y
  pair_sqr<K1Field>(t0, t2, p.Y, p.Z, odd);
  pair_mul<K1Field>(t1, xy, p.Y, p.Z, p.X, p.Y, odd);
  k1_add(z3, t0, t0);
  k1_add(z3, z3, z3);
  k1_add(z3, z3, z3);
  k1_mul_small(t2, t2, K1_B3);
  k1_add(y3, t0, t2);
  k1_add(u, t2, t2);
  k1_add(u, u, t2);
  k1_sub(t0, t0, u);
  // t2 z3 | t0 y3, then Y = their sum
  fe_pick(u, odd, t0, t2);
  fe_pick(v, odd, y3, z3);
  k1_mul(m, u, v);
  pair_other(w, m);
  k1_add(o.Y, m, w);
  // YZ z3 | t0 XY
  fe_pick(u, odd, t0, t1);
  fe_pick(v, odd, xy, z3);
  k1_mul(m, u, v);
  pair_share(o.Z, w, m, odd);
  k1_add(o.X, w, w);
}

// The secp256k1 side of the two-curve pair kernels
// (csrc/weierstrass_shamir.cu, csrc/weierstrass_windowed.cu).
struct K1PairCurve {
  typedef k1fe fe;
  typedef k1pt pt;
  typedef K1Field field;
  static __device__ __forceinline__ void identity(pt &o) { k1pt_identity(o); }
  static __device__ __forceinline__ void add(pt &o, const pt &p, const pt &q,
                                             bool odd) {
    k1pt_add_pair(o, p, q, odd);
  }
  static __device__ __forceinline__ void dbl(pt &o, const pt &p, bool odd) {
    k1pt_dbl_pair(o, p, odd);
  }
  static __device__ __forceinline__ void madd(pt &o, const pt &p,
                                              const fe &x2, const fe &y2,
                                              bool odd) {
    k1pt_madd_pair(o, p, x2, y2, odd);
  }
  static __device__ __forceinline__ void load16(fe &o, const uint16_t *src) {
    k1_load16(o, src);
  }
  static __device__ __forceinline__ void one(fe &o) { k1_one(o); }
  static __device__ __forceinline__ void order(fe &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o.v[k] = K1_N[k];
  }
  static __device__ __forceinline__ void fadd(fe &o, const fe &a,
                                              const fe &b) {
    k1_add(o, a, b);
  }
  static __device__ __forceinline__ void generator(pt &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o.X.v[k] = K1_GX[k];
      o.Y.v[k] = K1_GY[k];
    }
    k1_one(o.Z);
  }
  static __device__ __forceinline__ bool eq(const fe &a, const fe &b) {
    return k1_eq(a, b);
  }
  static __device__ __forceinline__ bool is_zero(const fe &a) {
    return k1_is_zero(a);
  }
};
