// Projective P-256 formulas over a lane pair, for the pair kernels of B4
// (csrc/secp256r1_split.cu) and B8 (csrc/weierstrass_shamir.cu), on the
// Comba field csrc/field_p256_comba.cuh: the complete a = -3 formulas of
// Renes-Costello-Batina 2016 (Algorithms 4, 5 and 6).
//
// Replaces the a = -3 branches of corda_tpu/ops/weierstrass.py add, dbl
// and _madd_w, as csrc/curve_p256.cuh does for one thread: each formula
// computes that file's field values step for step, and only which lane
// computes a product changes (csrc/lanes.cuh). Every formula has three
// layers of independent products (first layer, the products by b, last
// layer), so a pair runs 3 + 1 + 3 products deep where one thread runs
// 13-14. The identity is (0:1:0); the mixed addition is not valid for an
// identity addend (the kernel keeps the accumulator on flag-0 rows).
//
// Its field and point types take the names of the one-thread kernels'
// (csrc/curve_p256.cuh); no translation unit includes both headers.
#pragma once
#include <stdint.h>

#include "field_p256_comba.cuh"
#include "lanes.cuh"

// The generator G, little-endian words.
__device__ __constant__ uint32_t P256_GX[8] = {
    0xd898c296u, 0xf4a13945u, 0x2deb33a0u, 0x77037d81u,
    0x63a440f2u, 0xf8bce6e5u, 0xe12c4247u, 0x6b17d1f2u};
__device__ __constant__ uint32_t P256_GY[8] = {
    0x37bf51f5u, 0xcbb64068u, 0x6b315eceu, 0x2bce3357u,
    0x7c0f9e16u, 0x8ee7eb4au, 0xfe1a7f9bu, 0x4fe342e2u};
// The group order n, little-endian words.
__device__ __constant__ uint32_t P256_N[8] = {
    0xfc632551u, 0xf3b9cac2u, 0xa7179e84u, 0xbce6faadu,
    0xffffffffu, 0xffffffffu, 0x00000000u, 0xffffffffu};

struct r1pt {
  p256fe X, Y, Z;
};

__device__ __forceinline__ void r1pt_identity(r1pt &o) {
  p256_zero(o.X);
  p256_one(o.Y);
  p256_zero(o.Z);
}

__device__ __forceinline__ void p256_b(p256fe &o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = P256_B[i];
}

__device__ __forceinline__ void p256_load16(p256fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

struct P256Field {
  typedef p256fe elem;
  static __device__ __forceinline__ void mul(elem &o, const elem &a,
                                             const elem &b) {
    p256_mul(o, a, b);
  }
  static __device__ __forceinline__ void sqr(elem &o, const elem &a) {
    p256_sqr(o, a);
  }
};

// The last layer shared by Algorithms 4 and 5: X = t3 x3 - t4 y3,
// Y = x3 z3 + t0 y3, Z = t4 z3 + t3 t0; the even lane computes the first
// product of each, the odd lane the second.
__device__ __forceinline__ void r1_tail_pair(r1pt &o, const p256fe &t0,
                                             const p256fe &t3,
                                             const p256fe &t4,
                                             const p256fe &x3,
                                             const p256fe &y3,
                                             const p256fe &z3, bool odd) {
  p256fe u, v, m, w, X;
  fe_pick(u, odd, t4, t3);
  fe_pick(v, odd, y3, x3);
  p256_mul(m, u, v);
  pair_other(w, m);
  fe_pick(u, odd, w, m);
  fe_pick(v, odd, m, w);
  p256_sub(X, u, v);
  fe_pick(u, odd, t0, x3);
  fe_pick(v, odd, y3, z3);
  p256_mul(m, u, v);
  pair_other(w, m);
  p256_add(o.Y, m, w);
  fe_pick(u, odd, t3, t4);
  fe_pick(v, odd, t0, z3);
  p256_mul(m, u, v);
  pair_other(w, m);
  p256_add(o.Z, m, w);
  o.X = X;
}

// Algorithm 4 over a lane pair (r1pt_add's values).
__device__ __forceinline__ void r1pt_add_pair(r1pt &o, const r1pt &p,
                                              const r1pt &q, bool odd) {
  p256fe t0, t1, t2, t3, t4, x3, y3, z3, b, u, v, m;
  p256_b(b);
  // X1 X2 | Y1 Y2, Z1 Z2 | (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2) |
  // (X1 + Z1)(X2 + Z2)
  pair_mul<P256Field>(t0, t1, p.X, q.X, p.Y, q.Y, odd);
  p256_add(u, p.X, p.Y);
  p256_add(v, q.X, q.Y);
  pair_mul<P256Field>(t2, t3, p.Z, q.Z, u, v, odd);
  fe_pick(u, odd, p.X, p.Y);
  fe_pick(v, odd, q.X, q.Y);
  p256_add(u, u, p.Z);
  p256_add(v, v, q.Z);
  p256_mul(m, u, v);
  pair_share(t4, x3, m, odd);
  p256_add(u, t0, t1);
  p256_sub(t3, t3, u);
  p256_add(u, t1, t2);
  p256_sub(t4, t4, u);
  p256_add(y3, t0, t2);
  p256_sub(y3, x3, y3);
  // b t2 | b y3
  pair_mul<P256Field>(z3, v, b, t2, b, y3, odd);
  p256_sub(x3, y3, z3);
  p256_add(z3, x3, x3);
  p256_add(x3, x3, z3);
  p256_sub(z3, t1, x3);
  p256_add(x3, t1, x3);
  p256_add(t1, t2, t2);
  p256_add(t2, t1, t2);
  p256_sub(y3, v, t2);
  p256_sub(y3, y3, t0);
  p256_add(t1, y3, y3);
  p256_add(y3, t1, y3);
  p256_add(t1, t0, t0);
  p256_add(t0, t1, t0);
  p256_sub(t0, t0, t2);
  r1_tail_pair(o, t0, t3, t4, x3, y3, z3, odd);
}

// Algorithm 5 over a lane pair (r1pt_madd's values).
__device__ __forceinline__ void r1pt_madd_pair(r1pt &o, const r1pt &p,
                                               const p256fe &x2,
                                               const p256fe &y2, bool odd) {
  p256fe t0, t1, t2, t3, t4, x3, y3, z3, b, u, v;
  p256_b(b);
  // X1 x2 | Y1 y2, y2 Z1 | x2 Z1, b Z1 | (x2 + y2)(X1 + Y1)
  pair_mul<P256Field>(t0, t1, p.X, x2, p.Y, y2, odd);
  fe_pick(u, odd, x2, y2);
  pair_mul<P256Field>(t4, y3, u, p.Z, u, p.Z, odd);
  p256_add(u, x2, y2);
  p256_add(v, p.X, p.Y);
  pair_mul<P256Field>(z3, t3, b, p.Z, u, v, odd);
  p256_add(u, t0, t1);
  p256_sub(t3, t3, u);
  p256_add(t4, t4, p.Y);
  p256_add(y3, y3, p.X);
  p256_sub(x3, y3, z3);
  p256_add(z3, x3, x3);
  p256_add(x3, x3, z3);
  p256_sub(z3, t1, x3);
  p256_add(x3, t1, x3);
  // b y3, on both lanes
  p256_mul(y3, b, y3);
  p256_add(t1, p.Z, p.Z);
  p256_add(t2, t1, p.Z);
  p256_sub(y3, y3, t2);
  p256_sub(y3, y3, t0);
  p256_add(t1, y3, y3);
  p256_add(y3, t1, y3);
  p256_add(t1, t0, t0);
  p256_add(t0, t1, t0);
  p256_sub(t0, t0, t2);
  r1_tail_pair(o, t0, t3, t4, x3, y3, z3, odd);
}

// Algorithm 6 over a lane pair (r1pt_dbl's values): X = x3 t3 - 2YZ z3,
// Y = x3 y3 + t0 z3, Z = 4 (2YZ) Y^2.
__device__ __forceinline__ void r1pt_dbl_pair(r1pt &o, const r1pt &p,
                                              bool odd) {
  p256fe t0, t1, t2, t3, x3, y3, z3, w, b, u, v, m;
  p256_b(b);
  // X^2 | Y^2, Z Z | X Y, X Z | Y Z
  pair_sqr<P256Field>(t0, t1, p.X, p.Y, odd);
  pair_mul<P256Field>(t2, t3, p.Z, p.Z, p.X, p.Y, odd);
  pair_mul<P256Field>(z3, w, p.X, p.Z, p.Y, p.Z, odd);
  p256_add(t3, t3, t3);
  p256_add(z3, z3, z3);
  p256_add(w, w, w);
  // b t2 | b z3
  pair_mul<P256Field>(y3, v, b, t2, b, z3, odd);
  p256_sub(y3, y3, z3);
  p256_add(x3, y3, y3);
  p256_add(y3, x3, y3);
  p256_sub(x3, t1, y3);
  p256_add(y3, t1, y3);
  p256_add(u, t2, t2);
  p256_add(t2, t2, u);
  p256_sub(z3, v, t2);
  p256_sub(z3, z3, t0);
  p256_add(u, z3, z3);
  p256_add(z3, z3, u);
  p256_add(u, t0, t0);
  p256_add(t0, u, t0);
  p256_sub(t0, t0, t2);
  // x3 t3 | 2YZ z3, x3 y3 | t0 z3, then 2YZ Y^2 on both lanes
  fe_pick(u, odd, w, x3);
  fe_pick(v, odd, z3, t3);
  p256_mul(m, u, v);
  pair_other(t2, m);
  fe_pick(u, odd, t2, m);
  fe_pick(v, odd, m, t2);
  p256_sub(o.X, u, v);
  fe_pick(u, odd, t0, x3);
  fe_pick(v, odd, z3, y3);
  p256_mul(m, u, v);
  pair_other(t2, m);
  p256_add(o.Y, m, t2);
  p256_mul(m, w, t1);
  p256_add(m, m, m);
  p256_add(o.Z, m, m);
}

// The secp256r1 side of the two-curve pair kernels
// (csrc/weierstrass_shamir.cu, csrc/weierstrass_windowed.cu).
struct P256PairCurve {
  typedef p256fe fe;
  typedef r1pt pt;
  typedef P256Field field;
  static __device__ __forceinline__ void identity(pt &o) { r1pt_identity(o); }
  static __device__ __forceinline__ void add(pt &o, const pt &p, const pt &q,
                                             bool odd) {
    r1pt_add_pair(o, p, q, odd);
  }
  static __device__ __forceinline__ void dbl(pt &o, const pt &p, bool odd) {
    r1pt_dbl_pair(o, p, odd);
  }
  static __device__ __forceinline__ void madd(pt &o, const pt &p,
                                              const fe &x2, const fe &y2,
                                              bool odd) {
    r1pt_madd_pair(o, p, x2, y2, odd);
  }
  static __device__ __forceinline__ void load16(fe &o, const uint16_t *src) {
    p256_load16(o, src);
  }
  static __device__ __forceinline__ void one(fe &o) { p256_one(o); }
  static __device__ __forceinline__ void order(fe &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o.v[k] = P256_N[k];
  }
  static __device__ __forceinline__ void fadd(fe &o, const fe &a,
                                              const fe &b) {
    p256_add(o, a, b);
  }
  static __device__ __forceinline__ void generator(pt &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o.X.v[k] = P256_GX[k];
      o.Y.v[k] = P256_GY[k];
    }
    p256_one(o.Z);
  }
  static __device__ __forceinline__ bool eq(const fe &a, const fe &b) {
    return p256_eq(a, b);
  }
  static __device__ __forceinline__ bool is_zero(const fe &a) {
    return p256_is_zero(a);
  }
};
