// Projective P-256 (secp256r1) points for Hopper device code: the complete
// a = -3 formulas of Renes-Costello-Batina 2016 (Algorithms 4, 5 and 6)
// over csrc/field_p256.cuh, the affine G-table add, and the P256Curve
// traits that the two-curve kernel csrc/weierstrass_windowed.cu is
// templated on.
//
// Replaces the a = -3 branches of corda_tpu/ops/weierstrass.py add, dbl and
// _madd_w (with _add_m3, _dbl_m3 and _m3_tail) for the one-thread kernel
// B5 (B4 and B8 Shamir run the lane-pair formulas of
// csrc/curve_p256_pair.cuh). Every formula has no data-dependent
// branch; the identity is (0:1:0). The mixed addition is not valid for an
// identity addend: table rows that hold the identity carry flag 0 and keep
// the accumulator (r1_g_add).
#pragma once
#include <stdint.h>

#include "field_p256.cuh"

// The generator G and the group order n, little-endian words.
__device__ __constant__ uint32_t P256_GX[8] = {
    0xd898c296u, 0xf4a13945u, 0x2deb33a0u, 0x77037d81u,
    0x63a440f2u, 0xf8bce6e5u, 0xe12c4247u, 0x6b17d1f2u};
__device__ __constant__ uint32_t P256_GY[8] = {
    0x37bf51f5u, 0xcbb64068u, 0x6b315eceu, 0x2bce3357u,
    0x7c0f9e16u, 0x8ee7eb4au, 0xfe1a7f9bu, 0x4fe342e2u};
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

// Complete addition, a = -3 (RCB16 Algorithm 4): 12 products + 2 by b.
__device__ __noinline__ void r1pt_add(r1pt &o, const r1pt &p, const r1pt &q) {
  p256fe t0, t1, t2, t3, t4, x3, y3, z3, b;
  p256_b(b);
  p256_mul(t0, p.X, q.X);
  p256_mul(t1, p.Y, q.Y);
  p256_mul(t2, p.Z, q.Z);
  p256_add(t3, p.X, p.Y);
  p256_add(t4, q.X, q.Y);
  p256_mul(t3, t3, t4);
  p256_add(t4, t0, t1);
  p256_sub(t3, t3, t4);
  p256_add(t4, p.Y, p.Z);
  p256_add(x3, q.Y, q.Z);
  p256_mul(t4, t4, x3);
  p256_add(x3, t1, t2);
  p256_sub(t4, t4, x3);
  p256_add(x3, p.X, p.Z);
  p256_add(y3, q.X, q.Z);
  p256_mul(x3, x3, y3);
  p256_add(y3, t0, t2);
  p256_sub(y3, x3, y3);
  p256_mul(z3, b, t2);
  p256_sub(x3, y3, z3);
  p256_add(z3, x3, x3);
  p256_add(x3, x3, z3);
  p256_sub(z3, t1, x3);
  p256_add(x3, t1, x3);
  p256_mul(y3, b, y3);
  p256_add(t1, t2, t2);
  p256_add(t2, t1, t2);
  p256_sub(y3, y3, t2);
  p256_sub(y3, y3, t0);
  p256_add(t1, y3, y3);
  p256_add(y3, t1, y3);
  p256_add(t1, t0, t0);
  p256_add(t0, t1, t0);
  p256_sub(t0, t0, t2);
  p256_mul(t1, t4, y3);
  p256_mul(t2, t0, y3);
  p256_mul(y3, x3, z3);
  p256_add(o.Y, y3, t2);
  p256_mul(x3, t3, x3);
  p256_sub(o.X, x3, t1);
  p256_mul(z3, t4, z3);
  p256_mul(t1, t3, t0);
  p256_add(o.Z, z3, t1);
}

// Mixed addition of an affine point (x2, y2), Z2 = 1, a = -3 (RCB16
// Algorithm 5): 11 products + 2 by b. Complete for every projective p; not
// valid for an identity addend.
__device__ __noinline__ void r1pt_madd(r1pt &o, const r1pt &p,
                                       const p256fe &x2, const p256fe &y2) {
  p256fe t0, t1, t2, t3, t4, x3, y3, z3, b;
  p256_b(b);
  p256_mul(t0, p.X, x2);
  p256_mul(t1, p.Y, y2);
  p256_add(t3, x2, y2);
  p256_add(t4, p.X, p.Y);
  p256_mul(t3, t3, t4);
  p256_add(t4, t0, t1);
  p256_sub(t3, t3, t4);
  p256_mul(t4, y2, p.Z);
  p256_add(t4, t4, p.Y);
  p256_mul(y3, x2, p.Z);
  p256_add(y3, y3, p.X);
  p256_mul(z3, b, p.Z);
  p256_sub(x3, y3, z3);
  p256_add(z3, x3, x3);
  p256_add(x3, x3, z3);
  p256_sub(z3, t1, x3);
  p256_add(x3, t1, x3);
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
  p256_mul(t1, t4, y3);
  p256_mul(t2, t0, y3);
  p256_mul(y3, x3, z3);
  p256_add(o.Y, y3, t2);
  p256_mul(x3, t3, x3);
  p256_sub(o.X, x3, t1);
  p256_mul(z3, t4, z3);
  p256_mul(t1, t3, t0);
  p256_add(o.Z, z3, t1);
}

// Complete doubling, a = -3 (RCB16 Algorithm 6): 8 products + 2 by b and 3
// squarings.
__device__ __noinline__ void r1pt_dbl(r1pt &o, const r1pt &p) {
  p256fe t0, t1, t2, t3, x3, y3, z3, b;
  p256_b(b);
  p256_sqr(t0, p.X);
  p256_sqr(t1, p.Y);
  p256_sqr(t2, p.Z);
  p256_mul(t3, p.X, p.Y);
  p256_add(t3, t3, t3);
  p256_mul(z3, p.X, p.Z);
  p256_add(z3, z3, z3);
  p256_mul(y3, b, t2);
  p256_sub(y3, y3, z3);
  p256_add(x3, y3, y3);
  p256_add(y3, x3, y3);
  p256_sub(x3, t1, y3);
  p256_add(y3, t1, y3);
  p256_mul(y3, x3, y3);
  p256_mul(x3, x3, t3);
  p256_add(t3, t2, t2);
  p256_add(t2, t2, t3);
  p256_mul(z3, b, z3);
  p256_sub(z3, z3, t2);
  p256_sub(z3, z3, t0);
  p256_add(t3, z3, z3);
  p256_add(z3, z3, t3);
  p256_add(t3, t0, t0);
  p256_add(t0, t3, t0);
  p256_sub(t0, t0, t2);
  p256_mul(t0, t0, z3);
  p256_add(y3, y3, t0);
  p256_mul(t0, p.Y, p.Z);
  p256_add(t0, t0, t0);
  p256_mul(z3, t0, z3);
  p256_sub(o.X, x3, z3);
  p256_mul(z3, t0, t1);
  p256_add(z3, z3, z3);
  p256_add(o.Z, z3, z3);
  o.Y = y3;
}

__device__ __forceinline__ void p256_load16(p256fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

// Mixed-adds the affine row ``row`` of one G table into acc; identity rows
// (flag 0) leave acc as it was.
__device__ __forceinline__ void r1_g_add(r1pt &acc, const uint16_t *tab_x,
                                         const uint16_t *tab_y,
                                         const uint8_t *tab_ok, int32_t row) {
  row &= 0xFFFF;
  p256fe x2, y2;
  p256_load16(x2, tab_x + (int64_t)row * 16);
  p256_load16(y2, tab_y + (int64_t)row * 16);
  r1pt sum;
  r1pt_madd(sum, acc, x2, y2);
  if (__ldg(tab_ok + row)) acc = sum;
}

// The secp256r1 side of the two-curve kernels.
struct P256Curve {
  typedef p256fe fe;
  typedef r1pt pt;
  static __device__ __forceinline__ void identity(pt &o) { r1pt_identity(o); }
  static __device__ __forceinline__ void add(pt &o, const pt &p,
                                             const pt &q) {
    r1pt_add(o, p, q);
  }
  static __device__ __forceinline__ void madd(pt &o, const pt &p,
                                              const fe &x2, const fe &y2) {
    r1pt_madd(o, p, x2, y2);
  }
  static __device__ __forceinline__ void dbl(pt &o, const pt &p) {
    r1pt_dbl(o, p);
  }
  static __device__ __forceinline__ void load16(fe &o, const uint16_t *src) {
    p256_load16(o, src);
  }
  static __device__ __forceinline__ void one(fe &o) { p256_one(o); }
  static __device__ __forceinline__ void generator(pt &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o.X.v[k] = P256_GX[k];
      o.Y.v[k] = P256_GY[k];
    }
    p256_one(o.Z);
  }
  static __device__ __forceinline__ void order(fe &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o.v[k] = P256_N[k];
  }
  static __device__ __forceinline__ void fadd(fe &o, const fe &a,
                                              const fe &b) {
    p256_add(o, a, b);
  }
  static __device__ __forceinline__ void mul(fe &o, const fe &a,
                                             const fe &b) {
    p256_mul(o, a, b);
  }
  static __device__ __forceinline__ bool eq(const fe &a, const fe &b) {
    return p256_eq(a, b);
  }
  static __device__ __forceinline__ bool is_zero(const fe &a) {
    return p256_is_zero(a);
  }
};
