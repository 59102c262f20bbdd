// Arithmetic mod p = 2^256 - 2^224 + 2^192 + 2^96 - 1 (P-256, secp256r1)
// for the lane-pair kernel of B4 (B1, P-256 fold; the one-thread kernels
// keep csrc/field_p256.cuh).
//
// Replaces the PSECR1 half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// canon and its signed Solinas fold _fold_once_r1). Elements are 8 x 32-bit
// words. Products are product-scanning (Comba) over PTX carry chains
// (csrc/carry.cuh): each column's 32x32 multiplies feed a three-word
// accumulator, so no 64-bit shifts sit between them; a squaring multiplies
// each cross term once and doubles (36 multiplies, not 64). The 512-bit
// product is reduced by the FIPS 186-4 fast reduction (D.2.3),
// T + 2S1 + 2S2 + S3 + S4 - D1 - D2 - D3 - D4, one add or subtract
// chain a term, with 5p added so that no intermediate goes negative.
//
// Contract: a p256fe holds any residue as a value in [0, 2^256); only
// p256_canon reduces below p. 2^256 = C = 2^224 - 2^192 - 2^96 + 1 (mod p).
#pragma once
#include <stdint.h>

#include "carry.cuh"

struct p256fe {
  uint32_t v[8];
};

// p, little-endian words.
__device__ __constant__ uint32_t P256_P[8] = {
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu};

// b, the curve constant (y^2 = x^3 - 3x + b), little-endian words.
__device__ __constant__ uint32_t P256_B[8] = {
    0x27d2604bu, 0x3bce3c3eu, 0xcc53b0f6u, 0x651d06b0u,
    0x769886bcu, 0xb3ebbd55u, 0xaa3a93e7u, 0x5ac635d8u};

__device__ __forceinline__ void p256_zero(p256fe &o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = 0;
}

__device__ __forceinline__ void p256_one(p256fe &o) {
  p256_zero(o);
  o.v[0] = 1;
}

// C = 2^256 - p, little-endian words.
__device__ __constant__ uint32_t P256_C[8] = {
    0x00000001u, 0x00000000u, 0x00000000u, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xfffffffeu, 0x00000000u};

// C's words masked by m (all ones or zero).
__device__ __forceinline__ void p256_c_masked(uint32_t k[8], uint32_t m) {
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = P256_C[i] & m;
}

// r + t*C for a value t * 2^256 + r, 0 <= t < 2^32 - 1, folded into
// [0, 2^256). t*C = [t, 0, 0, -t, m, m, -t-1, t-1] (words, m all ones when
// t > 0; all zero for t = 0). On a carry the words hold r + tC - 2^256 <
// tC, and adding C once more cannot carry.
__device__ __forceinline__ void p256_fold(uint32_t r[8], uint32_t t) {
  const uint32_t m = 0u - (uint32_t)(t != 0);
  const uint32_t k[8] = {t, 0, 0, 0u - t, m, m, (0u - t - 1u) & m,
                         (t - 1u) & m};
  uint32_t c[8];
  p256_c_masked(c, 0u - add8(r, r, k));
  add8(r, r, c);
}

// r - b*C for a borrow b in {0, 1}; returns the borrow out.
__device__ __forceinline__ uint32_t p256_sub_c(uint32_t r[8], uint32_t b) {
  uint32_t c[8];
  p256_c_masked(c, 0u - b);
  return sub8(r, r, c);
}

__device__ __forceinline__ void p256_add(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
  p256_fold(o.v, add8(o.v, a.v, b.v));
}

// a - b: a borrow means the words hold a - b + 2^256 = a - b + C (mod p),
// so C is subtracted; a second borrow (a - b < -p) subtracts it again,
// and then the words are >= 2^256 - C = p > C.
__device__ __forceinline__ void p256_sub(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
  p256_sub_c(o.v, p256_sub_c(o.v, sub8(o.v, a.v, b.v)));
}

// FIPS 186-4 D.2.3 on the 512-bit product c0..c15. The positive terms and
// 5p sum below 12 * 2^256; subtracting D1..D4 (each < 2^256 < 5p / 4)
// leaves t * 2^256 + r with 0 <= t <= 11, folded by p256_fold. Each term
// is one add or subtract chain; its carry or borrow moves the top word t.
__device__ __forceinline__ void p256_reduce512(p256fe &o, const uint32_t c[16]) {
  uint32_t r[8], t = 4;  // the top word of 5p
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = c[i];
  {  // S1 = (c15, c14, c13, c12, c11, 0, 0, 0), twice
    const uint32_t k[8] = {0, 0, 0, c[11], c[12], c[13], c[14], c[15]};
    t += add8(r, r, k);
    t += add8(r, r, k);
  }
  {  // S2 = (0, c15, c14, c13, c12, 0, 0, 0), twice
    const uint32_t k[8] = {0, 0, 0, c[12], c[13], c[14], c[15], 0};
    t += add8(r, r, k);
    t += add8(r, r, k);
  }
  {  // S3 = (c15, c14, 0, 0, 0, c10, c9, c8)
    const uint32_t k[8] = {c[8], c[9], c[10], 0, 0, 0, c[14], c[15]};
    t += add8(r, r, k);
  }
  {  // S4 = (c8, c13, c15, c14, c13, c11, c10, c9)
    const uint32_t k[8] = {c[9], c[10], c[11], c[13], c[14], c[15], c[13],
                           c[8]};
    t += add8(r, r, k);
  }
  {  // 5p below 2^256
    const uint32_t k[8] = {0xfffffffbu, 0xffffffffu, 0xffffffffu, 4u,
                           0, 0, 5u, 0xfffffffbu};
    t += add8(r, r, k);
  }
  {  // D1 = (c10, c8, 0, 0, 0, c13, c12, c11)
    const uint32_t k[8] = {c[11], c[12], c[13], 0, 0, 0, c[8], c[10]};
    t -= sub8(r, r, k);
  }
  {  // D2 = (c11, c9, 0, 0, c15, c14, c13, c12)
    const uint32_t k[8] = {c[12], c[13], c[14], c[15], 0, 0, c[9], c[11]};
    t -= sub8(r, r, k);
  }
  {  // D3 = (c12, 0, c10, c9, c8, c15, c14, c13)
    const uint32_t k[8] = {c[13], c[14], c[15], c[8], c[9], c[10], 0,
                           c[12]};
    t -= sub8(r, r, k);
  }
  {  // D4 = (c13, 0, c11, c10, c9, 0, c15, c14)
    const uint32_t k[8] = {c[14], c[15], 0, c[9], c[10], c[11], 0, c[13]};
    t -= sub8(r, r, k);
  }
  p256_fold(r, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = r[i];
}

__device__ __forceinline__ void p256_mul(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
  uint32_t t[16];
  mul256_comba(t, a.v, b.v);
  p256_reduce512(o, t);
}

__device__ __forceinline__ void p256_sqr(p256fe &o, const p256fe &a) {
  uint32_t t[16];
  sqr256_comba(t, a.v);
  p256_reduce512(o, t);
}

// Canonical residue: a value < 2^256 = p + C < 2p needs at most one
// subtraction of p (branch-free).
__device__ __forceinline__ void p256_canon(p256fe &o, const p256fe &a) {
  uint32_t d[8];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] - (int64_t)P256_P[i];
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t keep = (uint32_t)c;  // all ones when a < p (borrow)
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = (a.v[i] & keep) | (d[i] & ~keep);
}

__device__ __forceinline__ bool p256_is_zero(const p256fe &a) {
  p256fe c;
  p256_canon(c, a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= c.v[i];
  return acc == 0;
}

// Canonical a == canonical b.
__device__ __forceinline__ bool p256_eq(const p256fe &a, const p256fe &b) {
  p256fe ca, cb;
  p256_canon(ca, a);
  p256_canon(cb, b);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= ca.v[i] ^ cb.v[i];
  return acc == 0;
}
