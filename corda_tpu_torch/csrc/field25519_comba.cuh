// Arithmetic mod p = 2^255 - 19 for the lane-pair kernels of B2 and both
// B7 kernels (B1, p25519; the one-lane kernels keep csrc/field25519.cuh).
//
// Replaces the p25519 half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// mul_const, canon, inv25519), which kept 16 x 16-bit limbs in u64 lanes
// under a relaxed-limb contract because the TPU vector unit has no wide
// multiply. Here each thread owns whole elements as 8 x 32-bit words;
// products are product-scanning (Comba) over PTX carry chains
// (csrc/carry.cuh), a squaring multiplies each cross term once (36
// multiplies, not 64), and the fold by 38 is two multiply-add chains.
//
// Contract: an fe holds any residue as a value in [0, 2^256) (words little
// endian, not reduced below p). Every operation returns a value in
// [0, 2^256); only fe_canon reduces below p. 2^256 = 38 (mod p), so a carry
// out of the top word re-enters word 0 times 38.
//
// The two __noinline__ functions, fe_sqr_n and fe_inv, take and return
// their element by value (see fe_inv).
#pragma once
#include <stdint.h>

#include "carry.cuh"

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

// r + c * 2^256 for c < 2^26, folded below 2^256: c*38 is added into word
// 0 and carried through; a second carry out can only happen when the low
// 256 bits are then tiny (< c*38), so adding 38 for it cannot carry again.
__device__ __forceinline__ void fe_fold_carry(uint32_t r[8], uint32_t c) {
  const uint32_t k[8] = {c * 38u, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t c2 = add8(r, r, k);
  r[0] += c2 * 38u;
}

__device__ __forceinline__ void fe_add(fe &o, const fe &a, const fe &b) {
  fe_fold_carry(o.v, add8(o.v, a.v, b.v));
}

// a - b: a borrow out of the top word means the result is r - 2^256, which
// is r - 38 (mod p); subtracting 38 can borrow once more only when r < 38,
// and then the wrapped value is >= 2^256 - 38, whose last -38 cannot borrow.
__device__ __forceinline__ void fe_sub(fe &o, const fe &a, const fe &b) {
  const uint32_t k[8] = {sub8(o.v, a.v, b.v) * 38u, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t b2 = sub8(o.v, o.v, k);
  o.v[0] -= b2 * 38u;
}

// a * k for a small constant k (< 2^26): the low words of each a_i * k,
// then their high words one place up, the top word folded.
__device__ __forceinline__ void fe_mul_small(fe &o, const fe &a, uint32_t k) {
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = a.v[i] * k;
  fe_fold_carry(r, madhi8(r, a.v, k, 0));
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = r[i];
}

// 512-bit product t[16] folded below 2^256: lo + 38*hi, the low words of
// each 38 * t_(i+8) into word i and their high words into word i + 1; the
// carry out (at most 39) is folded by fe_fold_carry.
__device__ __forceinline__ void fe_reduce512(fe &o, const uint32_t t[16]) {
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = t[i];
  const uint32_t top = madlo8(r, t + 8, 38u);
  fe_fold_carry(r, madhi8(r, t + 8, 38u, top));
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = r[i];
}

// Product-scanning (Comba) 512-bit product on carry chains (csrc/carry.cuh),
// then the fold.
__device__ __forceinline__ void fe_mul(fe &o, const fe &a, const fe &b) {
  uint32_t t[16];
  mul256_comba(t, a.v, b.v);
  fe_reduce512(o, t);
}

// Dedicated squaring: 36 multiplies (each cross product once, doubled).
__device__ __forceinline__ void fe_sqr(fe &o, const fe &a) {
  uint32_t t[16];
  sqr256_comba(t, a.v);
  fe_reduce512(o, t);
}

// a^(2^n). Takes and returns its element by value, as fe_inv does.
__device__ __noinline__ fe fe_sqr_n(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_sqr(a, a);
  return a;
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

// Hands each value of fe_inv's chain to a diagnostic build (step 0 the
// input, steps 1-22 the 11 squaring calls and 11 products in order);
// nothing otherwise.
#ifndef FE_INV_STEP
#define FE_INV_STEP(k, value)
#endif

// a^(p-2) by the curve25519 addition chain: 254 squarings + 11 multiplies
// (the chain of field.py inv25519); 0 maps to 0.
//
// By value, as fe_sqr_n: an element a kernel passes by reference to a
// __noinline__ function lives in the kernel's local-memory frame. While
// the Comba products kept their operands there too (csrc/carry.cuh), nvcc
// (12.9, sm_90a) gave zi, this function's output in B7 windowed's pair
// kernel built with -DED25519_WINDOWED_PAIR_AFFINE, the frame slot of the
// first operand of the product after the call: the PTX stored the lane's
// pick of X or Y over zi, then read zi back, so every valid signature
// failed (ROADMAP §C.1, csrc/diag/frame_slot_repro.cu). Passed and
// returned in .param space, zi stays in registers and no slot of the
// caller's frame is addressed by the call.
__device__ __noinline__ fe fe_inv(fe a) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0, o;
  FE_INV_STEP(0, a);
  fe_sqr(z2, a);                    // 2
  FE_INV_STEP(1, z2);
  t = fe_sqr_n(z2, 2);              // 8
  FE_INV_STEP(2, t);
  fe_mul(z9, t, a);                 // 9
  FE_INV_STEP(3, z9);
  fe_mul(z11, z9, z2);              // 11
  FE_INV_STEP(4, z11);
  fe_sqr(t, z11);                   // 22
  FE_INV_STEP(5, t);
  fe_mul(z_5_0, t, z9);             // 2^5 - 1
  FE_INV_STEP(6, z_5_0);
  t = fe_sqr_n(z_5_0, 5);
  FE_INV_STEP(7, t);
  fe_mul(z_10_0, t, z_5_0);         // 2^10 - 1
  FE_INV_STEP(8, z_10_0);
  t = fe_sqr_n(z_10_0, 10);
  FE_INV_STEP(9, t);
  fe_mul(z_20_0, t, z_10_0);        // 2^20 - 1
  FE_INV_STEP(10, z_20_0);
  t = fe_sqr_n(z_20_0, 20);
  FE_INV_STEP(11, t);
  fe_mul(t, t, z_20_0);             // 2^40 - 1
  FE_INV_STEP(12, t);
  t = fe_sqr_n(t, 10);
  FE_INV_STEP(13, t);
  fe_mul(z_50_0, t, z_10_0);        // 2^50 - 1
  FE_INV_STEP(14, z_50_0);
  t = fe_sqr_n(z_50_0, 50);
  FE_INV_STEP(15, t);
  fe_mul(z_100_0, t, z_50_0);       // 2^100 - 1
  FE_INV_STEP(16, z_100_0);
  t = fe_sqr_n(z_100_0, 100);
  FE_INV_STEP(17, t);
  fe_mul(t, t, z_100_0);            // 2^200 - 1
  FE_INV_STEP(18, t);
  t = fe_sqr_n(t, 50);
  FE_INV_STEP(19, t);
  fe_mul(t, t, z_50_0);             // 2^250 - 1
  FE_INV_STEP(20, t);
  t = fe_sqr_n(t, 5);
  FE_INV_STEP(21, t);
  fe_mul(o, t, z11);                // 2^255 - 21
  FE_INV_STEP(22, o);
  return o;
}
