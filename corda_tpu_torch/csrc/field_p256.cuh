// Arithmetic mod p = 2^256 - 2^224 + 2^192 + 2^96 - 1 (P-256, secp256r1)
// for Hopper device code (B1, P-256 fold).
//
// Replaces the PSECR1 half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// canon and its signed Solinas fold _fold_once_r1). Elements are 8 x 32-bit
// words; products use the card's 32x32->64 multiply-add and are reduced by
// the FIPS 186-4 fast reduction (D.2.3), which is defined on exactly these
// 32-bit words: T + 2S1 + 2S2 + S3 + S4 - D1 - D2 - D3 - D4.
//
// Contract: a p256fe holds any residue as a value in [0, 2^256); only
// p256_canon reduces below p. 2^256 = C = 2^224 - 2^192 - 2^96 + 1 (mod p),
// so a signed carry c out of the top word re-enters as +c at word 0, -c at
// words 3 and 6 and +c at word 7.
#pragma once
#include <stdint.h>

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

// r + c*C for a signed carry c (|c| < 2^31), returned with the signed carry
// out of the top word (C's terms enter words 0, 3, 6 and 7).
__device__ __forceinline__ int64_t p256_add_c(uint32_t r[8], int64_t c) {
  int64_t t = (int64_t)r[0] + c;
  r[0] = (uint32_t)t;
  t >>= 32;  // arithmetic shift: carries and borrows alike
  t += r[1];
  r[1] = (uint32_t)t;
  t >>= 32;
  t += r[2];
  r[2] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)r[3] - c;
  r[3] = (uint32_t)t;
  t >>= 32;
  t += r[4];
  r[4] = (uint32_t)t;
  t >>= 32;
  t += r[5];
  r[5] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)r[6] - c;
  r[6] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)r[7] + c;
  r[7] = (uint32_t)t;
  t >>= 32;
  return t;
}

// The words r plus c * 2^256, folded into [0, 2^256), for the carries the
// callers make: c in [-4, 6] or 0 <= c < 2^26. With L = r in [0, 2^256)
// and C < 2^224, L + c*C leaves a carry in {-1, 0, 1}. On +1 the words
// hold L + c*C - 2^256 < c*C < 2^250, and adding C cannot carry; on -1
// they hold L + c*C + 2^256 >= 2^256 - 4C, and subtracting C cannot borrow.
__device__ __forceinline__ void p256_fold_carry(uint32_t r[8], int64_t c) {
  const int64_t c2 = p256_add_c(r, c);
  p256_add_c(r, c2);
}

__device__ __forceinline__ void p256_add(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] + b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  p256_fold_carry(o.v, c);
}

__device__ __forceinline__ void p256_sub(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] - (int64_t)b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  p256_fold_carry(o.v, c);
}

// a * k for a small constant k (< 2^26).
__device__ __forceinline__ void p256_mul_small(p256fe &o, const p256fe &a,
                                               uint32_t k) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)((uint64_t)a.v[i] * k);
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  p256_fold_carry(o.v, c);
}

// FIPS 186-4 D.2.3 on the 512-bit product c0..c15, word by word with a
// signed accumulator: each word sums at most six positive and four negative
// 32-bit terms plus the carry, far inside int64; the final carry is in
// [-4, 6].
__device__ __forceinline__ void p256_reduce512(p256fe &o, const uint32_t c[16]) {
  int64_t t;
  t = (int64_t)c[0] + c[8] + c[9] - c[11] - c[12] - c[13] - c[14];
  o.v[0] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[1] + c[9] + c[10] - c[12] - c[13] - c[14] - c[15];
  o.v[1] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[2] + c[10] + c[11] - c[13] - c[14] - c[15];
  o.v[2] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[3] + 2 * (int64_t)c[11] + 2 * (int64_t)c[12] + c[13] -
       c[15] - c[8] - c[9];
  o.v[3] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[4] + 2 * (int64_t)c[12] + 2 * (int64_t)c[13] + c[14] -
       c[9] - c[10];
  o.v[4] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[5] + 2 * (int64_t)c[13] + 2 * (int64_t)c[14] + c[15] -
       c[10] - c[11];
  o.v[5] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[6] + 3 * (int64_t)c[14] + 2 * (int64_t)c[15] + c[13] -
       c[8] - c[9];
  o.v[6] = (uint32_t)t;
  t >>= 32;
  t += (int64_t)c[7] + 3 * (int64_t)c[15] + c[8] - c[10] - c[11] - c[12] -
       c[13];
  o.v[7] = (uint32_t)t;
  t >>= 32;
  p256_fold_carry(o.v, t);
}

// Operand-scanning schoolbook product: 64 32x32->64 multiply-adds (bounds
// as in field25519.cuh), then the fast reduction.
__device__ __forceinline__ void p256_mul(p256fe &o, const p256fe &a,
                                         const p256fe &b) {
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
  p256_reduce512(o, t);
}

__device__ __forceinline__ void p256_sqr(p256fe &o, const p256fe &a) {
  p256_mul(o, a, a);
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
