// Arithmetic mod p = 2^256 - 2^32 - 977 (secp256k1) for Hopper device code
// (B1, secp256k1 fold).
//
// Replaces the PSECP half of corda_tpu/ops/field.py (mul, sqr, add, sub,
// mul_const, canon), which kept 16 x 16-bit limbs in u64 lanes under a
// relaxed-limb contract because the TPU vector unit has no wide multiply.
// Here each thread owns whole elements as 8 x 32-bit words and uses the
// card's 32x32->64 integer multiply-add directly, as field25519.cuh does.
//
// Contract: a k1fe holds any residue as a value in [0, 2^256) (words little
// endian, not reduced below p). Every operation returns a value in
// [0, 2^256); only k1_canon reduces below p. 2^256 = C = 2^32 + 977
// (mod p), so a carry c out of the top word re-enters as c*977 at word 0
// and c at word 1.
#pragma once
#include <stdint.h>

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

// r + c*C for c < 2^34, returned with its carry out of the top word (0 or
// 1): c*977 < 2^44 and c < 2^34 enter words 0 and 1.
__device__ __forceinline__ uint32_t k1_add_c(uint32_t r[8], uint64_t c) {
  uint64_t t = (uint64_t)r[0] + c * 977u;
  r[0] = (uint32_t)t;
  t >>= 32;
  t += (uint64_t)r[1] + c;
  r[1] = (uint32_t)t;
  t >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    t += r[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  return (uint32_t)t;
}

// r + c * 2^256 folded below 2^256. A second carry out can only happen
// when the low 256 bits are then below c*C < 2^67, so adding C for it
// cannot carry again.
__device__ __forceinline__ void k1_fold_carry(uint32_t r[8], uint64_t c) {
  const uint32_t c2 = k1_add_c(r, c);
  k1_add_c(r, c2);
}

__device__ __forceinline__ void k1_add(k1fe &o, const k1fe &a, const k1fe &b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  k1_fold_carry(o.v, c);
}

// r - m*C for m in {0, 1}, returned with its borrow (0 or 1).
__device__ __forceinline__ uint32_t k1_sub_c(uint32_t r[8], uint32_t m) {
  int64_t t = (int64_t)r[0] - (int64_t)m * 977;
  r[0] = (uint32_t)t;
  t >>= 32;  // arithmetic: 0 or -1
  t += (int64_t)r[1] - (int64_t)m;
  r[1] = (uint32_t)t;
  t >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    t += r[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  return (uint32_t)(-t);
}

// a - b: a borrow out of the top word means the words hold r + 2^256, which
// is r + C (mod p), so C is subtracted; that borrows once more only when the
// words were below C, and then the wrapped value is >= 2^256 - C, from
// which C is subtracted without a borrow.
__device__ __forceinline__ void k1_sub(k1fe &o, const k1fe &a, const k1fe &b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] - (int64_t)b.v[i];
    o.v[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: 0 or -1
  }
  const uint32_t m = k1_sub_c(o.v, (uint32_t)(-c));
  k1_sub_c(o.v, m);
}

// a * k for a small constant k (< 2^26).
__device__ __forceinline__ void k1_mul_small(k1fe &o, const k1fe &a,
                                             uint32_t k) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] * k;
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  k1_fold_carry(o.v, c);
}

// 512-bit product t[16] = L + H*2^256 folded as L + 977*H + 2^32*H: the
// 2^32*H term is H shifted by one word, whose top word t[15] lands at 2^256
// and joins the carry (< 2^34) that k1_fold_carry takes.
__device__ __forceinline__ void k1_reduce512(k1fe &o, const uint32_t t[16]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)t[i] + (uint64_t)t[i + 8] * 977u;
    if (i > 0) c += t[i + 7];
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
  k1_fold_carry(o.v, c + t[15]);
}

// Operand-scanning schoolbook product: 64 32x32->64 multiply-adds. Each
// step's a*b + t + carry is at most (2^32-1)^2 + 2(2^32-1) = 2^64 - 1.
__device__ __forceinline__ void k1_mul(k1fe &o, const k1fe &a, const k1fe &b) {
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
  k1_reduce512(o, t);
}

// Squaring shares the product's code (a triangular square is later work).
__device__ __forceinline__ void k1_sqr(k1fe &o, const k1fe &a) {
  k1_mul(o, a, a);
}

// Canonical residue: a value < 2^256 = p + C < 2p needs at most one
// subtraction of p (branch-free).
__device__ __forceinline__ void k1_canon(k1fe &o, const k1fe &a) {
  uint32_t d[8];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (int64_t)a.v[i] - (int64_t)K1_P[i];
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t keep = (uint32_t)c;  // all ones when a < p (borrow)
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
