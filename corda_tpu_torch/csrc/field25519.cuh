// Arithmetic mod p = 2^255 - 19 for Hopper device code (B1, p25519 only).
//
// Replaces the p25519 half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// mul_const, canon, inv25519), which kept 16 x 16-bit limbs in u64 lanes
// under a relaxed-limb contract because the TPU vector unit has no wide
// multiply. Here each thread owns whole elements as 8 x 32-bit words and
// uses the card's 32x32->64 integer multiply-add directly.
//
// Contract: an fe holds any residue as a value in [0, 2^256) (words little
// endian, not reduced below p). Every operation returns a value in
// [0, 2^256); only fe_canon reduces below p. 2^256 = 38 (mod p), so a carry
// out of the top word re-enters word 0 times 38.
#pragma once
#include <stdint.h>

struct fe {
  uint32_t v[8];
};

// 2d mod p (d the edwards25519 curve constant), little-endian words.
__device__ __constant__ uint32_t FE_D2[8] = {
    0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
    0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};

// p = 2^255 - 19, little-endian words.
__device__ __constant__ uint32_t FE_P[8] = {
    0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};

__device__ __forceinline__ void fe_zero(fe &o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = 0;
}

__device__ __forceinline__ void fe_one(fe &o) {
  fe_zero(o);
  o.v[0] = 1;
}

// r + c * 2^256 with c < 2^26, folded below 2^256: c*38 is added into word
// 0 and carried through; a second carry out can only happen when the low
// 256 bits are then tiny (< c*38), so adding 38 for it cannot carry again.
__device__ __forceinline__ void fe_fold_carry(uint32_t r[8], uint64_t c) {
  uint64_t t = (uint64_t)r[0] + c * 38u;
  r[0] = (uint32_t)t;
  t >>= 32;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    t += r[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  r[0] += (uint32_t)t * 38u;
}

__device__ __forceinline__ void fe_add(fe &o, const fe &a, const fe &b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold_carry(o.v, c);
}

// a - b: a borrow out of the top word means the result is r - 2^256, which
// is r - 38 (mod p); subtracting 38 can borrow once more only when r < 38,
// and then the wrapped value is >= 2^256 - 38, whose last -38 cannot borrow.
__device__ __forceinline__ void fe_sub(fe &o, const fe &a, const fe &b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] - (int64_t)b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: 0 or -1
  }
  c = (int64_t)o.v[0] + c * 38;
  o.v[0] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    c += o.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  o.v[0] += (uint32_t)(c * 38);  // c is 0 or -1
}

// a * k for a small constant k (< 2^26).
__device__ __forceinline__ void fe_mul_small(fe &o, const fe &a, uint32_t k) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] * k;
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold_carry(o.v, c);
}

// 512-bit product t[16] folded below 2^256: lo + 38*hi leaves a carry of
// at most 38, folded by fe_fold_carry.
__device__ __forceinline__ void fe_reduce512(fe &o, const uint32_t t[16]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)t[i + 8] * 38u + t[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold_carry(o.v, c);
}

// Operand-scanning schoolbook product: 64 32x32->64 multiply-adds. Each
// step's a*b + t + carry is at most (2^32-1)^2 + 2(2^32-1) = 2^64 - 1.
__device__ __forceinline__ void fe_mul(fe &o, const fe &a, const fe &b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  fe_reduce512(o, t);
}

// Squaring shares the product's code; a dedicated triangular square (36
// instead of 64 products) is left to a later optimisation.
__device__ __forceinline__ void fe_sqr(fe &o, const fe &a) { fe_mul(o, a, a); }

__device__ __noinline__ void fe_sqr_n(fe &o, const fe &a, int n) {
  o = a;
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_sqr(o, o);
}

// v - p when v >= p, else v (branch-free).
__device__ __forceinline__ void fe_cond_sub_p(fe &v) {
  uint32_t d[8];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)v.v[i] - (int64_t)FE_P[i];
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t keep = (uint32_t)c;  // all ones when v < p (borrow)
#pragma unroll
  for (int i = 0; i < 8; ++i) v.v[i] = (v.v[i] & keep) | (d[i] & ~keep);
}

// Canonical residue: a value < 2^256 = 2p + 38 needs at most two
// subtractions of p.
__device__ __forceinline__ void fe_canon(fe &o, const fe &a) {
  o = a;
  fe_cond_sub_p(o);
  fe_cond_sub_p(o);
}

// a^(p-2) by the curve25519 addition chain: 254 squarings + 11 multiplies
// (the chain of field.py inv25519); 0 maps to 0.
__device__ __noinline__ void fe_inv(fe &o, const fe &a) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  fe_sqr(z2, a);                    // 2
  fe_sqr_n(t, z2, 2);               // 8
  fe_mul(z9, t, a);                 // 9
  fe_mul(z11, z9, z2);              // 11
  fe_sqr(t, z11);                   // 22
  fe_mul(z_5_0, t, z9);             // 2^5 - 1
  fe_sqr_n(t, z_5_0, 5);
  fe_mul(z_10_0, t, z_5_0);         // 2^10 - 1
  fe_sqr_n(t, z_10_0, 10);
  fe_mul(z_20_0, t, z_10_0);        // 2^20 - 1
  fe_sqr_n(t, z_20_0, 20);
  fe_mul(t, t, z_20_0);             // 2^40 - 1
  fe_sqr_n(t, t, 10);
  fe_mul(z_50_0, t, z_10_0);        // 2^50 - 1
  fe_sqr_n(t, z_50_0, 50);
  fe_mul(z_100_0, t, z_50_0);       // 2^100 - 1
  fe_sqr_n(t, z_100_0, 100);
  fe_mul(t, t, z_100_0);            // 2^200 - 1
  fe_sqr_n(t, t, 50);
  fe_mul(t, t, z_50_0);             // 2^250 - 1
  fe_sqr_n(t, t, 5);
  fe_mul(o, t, z11);                // 2^255 - 21
}
