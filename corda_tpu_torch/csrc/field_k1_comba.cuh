// Arithmetic mod p = 2^256 - 2^32 - 977 (secp256k1) for the lane-pair
// kernels of B3 and B8 (B1, secp256k1 fold; the one-thread kernels keep
// csrc/field_k1.cuh).
//
// Replaces the PSECP half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// mul_const, canon). Elements are 8 x 32-bit words. Products are
// product-scanning (Comba) over PTX carry chains (csrc/carry.cuh): each
// column's 32x32 multiplies feed a three-word accumulator; a squaring
// multiplies each cross term once and doubles (36 multiplies, not 64). The
// 512-bit product L + H * 2^256 is folded by 2^256 = C = 2^32 + 977
// (mod p): L + 977 H on two multiply-add chains, H shifted by one word on
// one add chain, then the top word t * C on one more add chain.
//
// Contract: a k1fe holds any residue as a value in [0, 2^256) (the same as
// csrc/field_k1.cuh); only k1_canon reduces below p.
#pragma once
#include <stdint.h>

#include "carry.cuh"

struct k1fe {
  uint32_t v[8];
};

// p, little-endian words.
__device__ __constant__ uint32_t K1_P[8] = {
    0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};

// n, the group order, little-endian words (the accept derives r + n).
__device__ __constant__ uint32_t K1_N[8] = {
    0xd0364141u, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u,
    0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu};

__device__ __forceinline__ void k1_zero(k1fe &o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = 0;
}

__device__ __forceinline__ void k1_one(k1fe &o) {
  k1_zero(o);
  o.v[0] = 1;
}

// r + t * 2^256 folded into [0, 2^256) for t < 2^34: t * C = t * 977 +
// t * 2^32 is a three-word value (< 2^67) added by one chain. On a carry
// the words hold r + tC - 2^256 < tC < 2^67, and adding C once more cannot
// carry.
__device__ __forceinline__ void k1_fold(uint32_t r[8], uint64_t t) {
  const uint64_t lo = t * 977u;
  const uint64_t mid = (lo >> 32) + t;
  const uint32_t k[8] = {(uint32_t)lo, (uint32_t)mid, (uint32_t)(mid >> 32),
                         0, 0, 0, 0, 0};
  const uint32_t c = add8(r, r, k);
  const uint32_t kc[8] = {977u & (0u - c), c, 0, 0, 0, 0, 0, 0};
  add8(r, r, kc);
}

__device__ __forceinline__ void k1_add(k1fe &o, const k1fe &a, const k1fe &b) {
  k1_fold(o.v, add8(o.v, a.v, b.v));
}

// r - m*C for m in {0, 1}; returns the borrow out.
__device__ __forceinline__ uint32_t k1_sub_c(uint32_t r[8], uint32_t m) {
  const uint32_t k[8] = {977u & (0u - m), m, 0, 0, 0, 0, 0, 0};
  return sub8(r, r, k);
}

// a - b: a borrow means the words hold a - b + 2^256 = a - b + C (mod p),
// so C is subtracted; that borrows once more only when the words were
// below C, and then the wrapped value is >= 2^256 - C, from which C is
// subtracted without a borrow.
__device__ __forceinline__ void k1_sub(k1fe &o, const k1fe &a, const k1fe &b) {
  k1_sub_c(o.v, k1_sub_c(o.v, sub8(o.v, a.v, b.v)));
}

// a * k for a small constant k (< 2^26): one multiply-add chain pair into
// zero words, the top word folded.
__device__ __forceinline__ void k1_mul_small(k1fe &o, const k1fe &a,
                                             uint32_t k) {
  k1fe z;
  k1_zero(z);
  const uint32_t c = madlo8(z.v, a.v, k);
  const uint32_t top = madhi8(z.v, a.v, k, c);
  k1_fold(z.v, top);
  o = z;
}

// The 512-bit t[16] = L + H * 2^256 folded below 2^256: L + 977 H leaves
// a top word <= 978; adding H * 2^32 (H shifted by one word) brings the
// top to at most 2^32 + 979, which k1_fold takes.
__device__ __forceinline__ void k1_reduce512(k1fe &o, const uint32_t t[16]) {
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = t[i];
  const uint32_t c = madlo8(r, t + 8, 977u);
  const uint32_t top = madhi8(r, t + 8, 977u, c);
  const uint32_t h[8] = {0, t[8], t[9], t[10], t[11], t[12], t[13], t[14]};
  const uint32_t c2 = add8(r, r, h);
  k1_fold(r, (uint64_t)top + t[15] + c2);
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = r[i];
}

__device__ __forceinline__ void k1_mul(k1fe &o, const k1fe &a, const k1fe &b) {
  uint32_t t[16];
  mul256_comba(t, a.v, b.v);
  k1_reduce512(o, t);
}

__device__ __forceinline__ void k1_sqr(k1fe &o, const k1fe &a) {
  uint32_t t[16];
  sqr256_comba(t, a.v);
  k1_reduce512(o, t);
}

// Canonical residue: a value < 2^256 = p + C < 2p needs at most one
// subtraction of p (branch-free).
__device__ __forceinline__ void k1_canon(k1fe &o, const k1fe &a) {
  uint32_t d[8], p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = K1_P[i];
  const uint32_t keep = 0u - sub8(d, a.v, p);  // all ones when a < p
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = (a.v[i] & keep) | (d[i] & ~keep);
}

__device__ __forceinline__ bool k1_is_zero(const k1fe &a) {
  k1fe c;
  k1_canon(c, a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= c.v[i];
  return acc == 0;
}

// Canonical a == canonical b.
__device__ __forceinline__ bool k1_eq(const k1fe &a, const k1fe &b) {
  k1fe ca, cb;
  k1_canon(ca, a);
  k1_canon(cb, b);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= ca.v[i] ^ cb.v[i];
  return acc == 0;
}
