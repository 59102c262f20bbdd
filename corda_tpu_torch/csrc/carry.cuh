// Multi-word integer steps for the Comba fields of the lane-pair kernels
// (B1 under B2, B3, B4 and B8 Shamir: csrc/field25519_comba.cuh,
// csrc/field_k1_comba.cuh, csrc/field_p256_comba.cuh):
// 8-word add and subtract with carry or borrow out, multiply-add rows, the
// 3-word Comba accumulator, and the doubling and diagonal chains of a
// squaring.
//
// Two implementations of each step:
// - on the card, PTX carry chains: add.cc/addc, sub.cc/subc and
//   mad.lo.cc/madc.hi, each chain ONE inline-asm statement with
//   early-clobber outputs, so the carry flag never has to survive between
//   statements;
// - off the card, portable C++ on 32- and 64-bit integers with the same
//   results, for checking the arithmetic against big integers as host
//   C++.
// The one-thread kernels keep the earlier fields (csrc/field25519.cuh,
// csrc/field_k1.cuh, csrc/field_p256.cuh): built on these fields, large
// one-thread kernels (B5's secp256r1 kernel, B7's windowed kernel, B2's
// and B4's one-lane kernels) rejected every valid signature on the card
// in some builds and not in others, on either implementation, with the
// same register and stack counts and after edits that change no value,
// and nvcc crashed on one of them; the host build was always right
// (PERF.md §6).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__

// (c2 : c1 : c0) += a * b
__device__ __forceinline__ void mac3(uint32_t &c0, uint32_t &c1,
                                     uint32_t &c2, uint32_t a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(a), "r"(b));
}

// r = a + b (8 words); returns the carry out.
__device__ __forceinline__ uint32_t add8(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]), "=&r"(r[4]),
        "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
}

// r = a - b (8 words); returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t sub8(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t c;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]), "=&r"(r[4]),
        "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c & 1u;
}

// r[0..7] += lo(a[i] * k) word by word with carries; returns the carry out.
__device__ __forceinline__ uint32_t madlo8(uint32_t r[8], const uint32_t a[8],
                                           uint32_t k) {
  uint32_t c;
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(k));
  return c;
}

// r[1..7] += hi(a[i - 1] * k) with carries; returns top + hi(a[7] * k) +
// the carry.
__device__ __forceinline__ uint32_t madhi8(uint32_t r[8], const uint32_t a[8],
                                           uint32_t k, uint32_t top) {
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7]), "+r"(top)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(k));
  return top;
}

// t[0..15] += t[0..15] (no carry out: the callers' values are < 2^511).
__device__ __forceinline__ void dbl16(uint32_t t[16]) {
  asm("add.cc.u32 %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.cc.u32 %14, %14, %14;\n\t"
      "addc.u32 %15, %15, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15]));
}

// t[2i : 2i+1] += a[i]^2 for i = 0..7, one chain (no carry out: the
// callers' sums are < 2^512).
__device__ __forceinline__ void addsq16(uint32_t t[16], const uint32_t a[8]) {
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}

#else  // portable C++ with the same results, off the card

__device__ __forceinline__ void mac3(uint32_t &c0, uint32_t &c1,
                                     uint32_t &c2, uint32_t a, uint32_t b) {
  const uint64_t p = (uint64_t)a * b;
  const uint64_t acc = (((uint64_t)c1 << 32) | c0) + p;
  c2 += acc < p;
  c0 = (uint32_t)acc;
  c1 = (uint32_t)(acc >> 32);
}

__device__ __forceinline__ uint32_t add8(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  return (uint32_t)t;
}

__device__ __forceinline__ uint32_t sub8(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  return (uint32_t)borrow;
}

__device__ __forceinline__ uint32_t madlo8(uint32_t r[8], const uint32_t a[8],
                                           uint32_t k) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t += (uint64_t)(uint32_t)((uint64_t)a[i] * k) + r[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  return (uint32_t)t;
}

__device__ __forceinline__ uint32_t madhi8(uint32_t r[8], const uint32_t a[8],
                                           uint32_t k, uint32_t top) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    t += (((uint64_t)a[i - 1] * k) >> 32) + r[i];
    r[i] = (uint32_t)t;
    t >>= 32;
  }
  return (uint32_t)(t + (((uint64_t)a[7] * k) >> 32) + top);
}

__device__ __forceinline__ void dbl16(uint32_t t[16]) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t hi = t[i] >> 31;
    t[i] = (t[i] << 1) | c;
    c = hi;
  }
}

__device__ __forceinline__ void addsq16(uint32_t t[16], const uint32_t a[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t p = (uint64_t)a[i] * a[i];
    c += (uint64_t)t[2 * i] + (uint32_t)p;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + t[2 * i + 1] + (p >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
}

#endif

// 512-bit a*b, product-scanning: column k accumulates a_i * b_(k-i) in
// (c2 : c1 : c0); a column of up to 8 products and the carry in stays
// below 2^96.
__device__ __forceinline__ void mul256_comba(uint32_t t[16],
                                             const uint32_t a[8],
                                             const uint32_t b[8]) {
  uint32_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#pragma unroll
    for (int i = (k < 8 ? 0 : k - 7); i <= (k < 8 ? k : 7); ++i)
      mac3(c0, c1, c2, a[i], b[k - i]);
    t[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  t[15] = c0;
}

// 512-bit a^2: the 28 cross products a_i * a_j (i < j) column by column,
// doubled by one add chain, plus the 8 squares a_i^2 by one multiply-add
// chain: 36 multiplies.
__device__ __forceinline__ void sqr256_comba(uint32_t t[16],
                                             const uint32_t a[8]) {
  uint32_t c0 = 0, c1 = 0, c2 = 0;
  t[0] = 0;
#pragma unroll
  for (int k = 1; k < 14; ++k) {
#pragma unroll
    for (int i = (k < 8 ? 0 : k - 7); 2 * i < k; ++i)
      mac3(c0, c1, c2, a[i], a[k - i]);
    t[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  t[14] = c0;
  t[15] = c1;
  dbl16(t);
  addsq16(t, a);
}
