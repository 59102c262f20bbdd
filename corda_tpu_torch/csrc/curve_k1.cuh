// Projective secp256k1 points for Hopper device code: the complete a = 0
// formulas of Renes-Costello-Batina 2016 (Algorithms 7, 8 and 9, b3 = 21)
// over csrc/field_k1.cuh, the affine G-table add, and the K1Curve traits
// that the two-curve kernel csrc/weierstrass_windowed.cu is templated on.
//
// Replaces the a = 0 branches of corda_tpu/ops/weierstrass.py add, dbl and
// _madd_w (with _add_k1 and _madd_k1) for the one-thread kernels B5 and B8
// GLV, which share this one copy (B3 and B8 Shamir run the lane-pair
// formulas of csrc/curve_k1_pair.cuh). Every formula has no data-dependent branch; the
// identity is (0:1:0). The mixed addition is not valid for an identity
// addend: table rows that hold the identity carry flag 0 and keep the
// accumulator (k1_g_add).
#pragma once
#include <stdint.h>

#include "field_k1.cuh"

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

// Complete addition, a = 0 (RCB16 Algorithm 7): 12 products.
__device__ __noinline__ void k1pt_add(k1pt &o, const k1pt &p, const k1pt &q) {
  k1fe t0, t1, t2, t3, t4, x3, y3, z3;
  k1_mul(t0, p.X, q.X);
  k1_mul(t1, p.Y, q.Y);
  k1_mul(t2, p.Z, q.Z);
  k1_add(t3, p.X, p.Y);
  k1_add(t4, q.X, q.Y);
  k1_mul(t3, t3, t4);
  k1_add(t4, t0, t1);
  k1_sub(t3, t3, t4);
  k1_add(t4, p.Y, p.Z);
  k1_add(x3, q.Y, q.Z);
  k1_mul(t4, t4, x3);
  k1_add(x3, t1, t2);
  k1_sub(t4, t4, x3);
  k1_add(x3, p.X, p.Z);
  k1_add(y3, q.X, q.Z);
  k1_mul(x3, x3, y3);
  k1_add(y3, t0, t2);
  k1_sub(y3, x3, y3);
  k1_add(x3, t0, t0);
  k1_add(t0, x3, t0);
  k1_mul_small(t2, t2, K1_B3);
  k1_add(z3, t1, t2);
  k1_sub(t1, t1, t2);
  k1_mul_small(y3, y3, K1_B3);
  k1_mul(x3, t4, y3);
  k1_mul(t2, t3, t1);
  k1_sub(o.X, t2, x3);
  k1_mul(y3, y3, t0);
  k1_mul(t1, t1, z3);
  k1_add(o.Y, t1, y3);
  k1_mul(t0, t0, t3);
  k1_mul(z3, z3, t4);
  k1_add(o.Z, z3, t0);
}

// Mixed addition of an affine point (x2, y2), Z2 = 1, a = 0 (RCB16
// Algorithm 8): 11 products. Complete for every projective p; not valid for
// an identity addend.
__device__ __noinline__ void k1pt_madd(k1pt &o, const k1pt &p, const k1fe &x2,
                                       const k1fe &y2) {
  k1fe t0, t1, t2, t3, t4, x3, y3, z3;
  k1_mul(t0, p.X, x2);
  k1_mul(t1, p.Y, y2);
  k1_add(t3, x2, y2);
  k1_add(t4, p.X, p.Y);
  k1_mul(t3, t3, t4);
  k1_add(t4, t0, t1);
  k1_sub(t3, t3, t4);
  k1_mul(t4, y2, p.Z);
  k1_add(t4, t4, p.Y);
  k1_mul(y3, x2, p.Z);
  k1_add(y3, y3, p.X);
  k1_add(x3, t0, t0);
  k1_add(t0, x3, t0);
  k1_mul_small(t2, p.Z, K1_B3);
  k1_add(z3, t1, t2);
  k1_sub(t1, t1, t2);
  k1_mul_small(y3, y3, K1_B3);
  k1_mul(x3, t4, y3);
  k1_mul(t2, t3, t1);
  k1_sub(o.X, t2, x3);
  k1_mul(y3, y3, t0);
  k1_mul(t1, t1, z3);
  k1_add(o.Y, t1, y3);
  k1_mul(t0, t0, t3);
  k1_mul(z3, z3, t4);
  k1_add(o.Z, z3, t0);
}

// Complete doubling, a = 0 (RCB16 Algorithm 9): 6 products, 2 squarings.
__device__ __noinline__ void k1pt_dbl(k1pt &o, const k1pt &p) {
  k1fe t0, t1, t2, x3, y3, z3;
  k1_sqr(t0, p.Y);
  k1_add(z3, t0, t0);
  k1_add(z3, z3, z3);
  k1_add(z3, z3, z3);
  k1_mul(t1, p.Y, p.Z);
  k1_sqr(t2, p.Z);
  k1_mul_small(t2, t2, K1_B3);
  k1_mul(x3, t2, z3);
  k1_add(y3, t0, t2);
  k1_mul(z3, t1, z3);
  k1_add(t1, t2, t2);
  k1_add(t2, t1, t2);
  k1_sub(t0, t0, t2);
  k1_mul(y3, t0, y3);
  k1_add(y3, x3, y3);
  k1_mul(t1, p.X, p.Y);
  k1_mul(x3, t0, t1);
  k1_add(o.X, x3, x3);
  o.Y = y3;
  o.Z = z3;
}

__device__ __forceinline__ void k1_load16(k1fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

// Mixed-adds the affine G-table row ``row`` into acc; identity rows
// (flag 0) leave acc as it was.
__device__ __forceinline__ void k1_g_add(k1pt &acc, const uint16_t *tab_x,
                                         const uint16_t *tab_y,
                                         const uint8_t *tab_ok, int32_t row) {
  k1fe x2, y2;
  k1_load16(x2, tab_x + (int64_t)row * 16);
  k1_load16(y2, tab_y + (int64_t)row * 16);
  k1pt sum;
  k1pt_madd(sum, acc, x2, y2);
  if (__ldg(tab_ok + row)) acc = sum;
}

// The secp256k1 side of the two-curve kernels.
struct K1Curve {
  typedef k1fe fe;
  typedef k1pt pt;
  static __device__ __forceinline__ void identity(pt &o) { k1pt_identity(o); }
  static __device__ __forceinline__ void add(pt &o, const pt &p,
                                             const pt &q) {
    k1pt_add(o, p, q);
  }
  static __device__ __forceinline__ void madd(pt &o, const pt &p,
                                              const fe &x2, const fe &y2) {
    k1pt_madd(o, p, x2, y2);
  }
  static __device__ __forceinline__ void dbl(pt &o, const pt &p) {
    k1pt_dbl(o, p);
  }
  static __device__ __forceinline__ void load16(fe &o, const uint16_t *src) {
    k1_load16(o, src);
  }
  static __device__ __forceinline__ void one(fe &o) { k1_one(o); }
  static __device__ __forceinline__ void generator(pt &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o.X.v[k] = K1_GX[k];
      o.Y.v[k] = K1_GY[k];
    }
    k1_one(o.Z);
  }
  static __device__ __forceinline__ void order(fe &o) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o.v[k] = K1_N[k];
  }
  static __device__ __forceinline__ void fadd(fe &o, const fe &a,
                                              const fe &b) {
    k1_add(o, a, b);
  }
  static __device__ __forceinline__ void mul(fe &o, const fe &a,
                                             const fe &b) {
    k1_mul(o, a, b);
  }
  static __device__ __forceinline__ bool eq(const fe &a, const fe &b) {
    return k1_eq(a, b);
  }
  static __device__ __forceinline__ bool is_zero(const fe &a) {
    return k1_is_zero(a);
  }
};
