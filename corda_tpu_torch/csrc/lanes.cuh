// Lane pairs: two adjacent lanes of a warp (an even lane and the odd one
// above it) run one signature together. Both lanes hold the whole point;
// each layer of independent field products in a formula is split so that
// the even lane computes one product of a slot and the odd lane the
// other, and one __shfl_xor_sync per word hands each result to the
// partner. Both lanes then run the formula's additions on the same
// values, so a pair never diverges and no lane waits on shared memory.
// Every lane of the warp must reach every exchange (no early exit).
#pragma once
#include <stdint.h>

#define PAIR_FULL_MASK 0xffffffffu

// o = c ? a : b, word by word (selects, no branch).
template <class FE>
__device__ __forceinline__ void fe_pick(FE &o, bool c, const FE &a,
                                        const FE &b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = c ? a.v[i] : b.v[i];
}

// The partner lane's m.
template <class FE>
__device__ __forceinline__ void pair_other(FE &o, const FE &m) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o.v[i] = __shfl_xor_sync(PAIR_FULL_MASK, m.v[i], 1);
}

// One slot of a layer: r0 = the even lane's m, r1 = the odd lane's m, on
// both lanes.
template <class FE>
__device__ __forceinline__ void pair_share(FE &r0, FE &r1, const FE &m,
                                           bool odd) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t o = __shfl_xor_sync(PAIR_FULL_MASK, m.v[i], 1);
    r0.v[i] = odd ? o : m.v[i];
    r1.v[i] = odd ? m.v[i] : o;
  }
}

// r0 = a0 * b0 (even lane) and r1 = a1 * b1 (odd lane), on both lanes.
template <class F>
__device__ __forceinline__ void pair_mul(typename F::elem &r0,
                                         typename F::elem &r1,
                                         const typename F::elem &a0,
                                         const typename F::elem &b0,
                                         const typename F::elem &a1,
                                         const typename F::elem &b1,
                                         bool odd) {
  typename F::elem x, y, m;
  fe_pick(x, odd, a1, a0);
  fe_pick(y, odd, b1, b0);
  F::mul(m, x, y);
  pair_share(r0, r1, m, odd);
}

// r0 = a0^2 (even lane) and r1 = a1^2 (odd lane), on both lanes.
template <class F>
__device__ __forceinline__ void pair_sqr(typename F::elem &r0,
                                         typename F::elem &r1,
                                         const typename F::elem &a0,
                                         const typename F::elem &a1,
                                         bool odd) {
  typename F::elem x, m;
  fe_pick(x, odd, a1, a0);
  F::sqr(m, x);
  pair_share(r0, r1, m, odd);
}

// 16-byte asynchronous copy from global to shared memory (cp.async.cg,
// cached in L2 only), and the wait for every copy this thread issued.
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
#ifdef __CUDACC__
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
#else
  memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// A 16-row table of points split between a pair's lanes: row k lives at
// T[k & 7] of the even lane for k < 8 and of the odd lane for k >= 8 (half
// the local memory of a whole table a lane). P is any point struct of
// 32-bit words (its field elements).
template <class P>
__device__ __forceinline__ void pair_row_put(P T[8], int k, const P &p,
                                             bool odd) {
  if ((k >> 3) == (int)odd) T[k & 7] = p;
}

// Row k on both lanes: each lane reads T[k & 7] of its own half, the owner
// keeps its copy and its partner takes it by shuffles, a word at a time.
template <class P>
__device__ __forceinline__ void pair_row_get(P &o, const P T[8], int k,
                                             bool odd) {
  static_assert(sizeof(P) % 4 == 0, "a row is whole 32-bit words");
  const P m = T[k & 7];
  const bool mine = (k >> 3) == (int)odd;
  const uint32_t *src = reinterpret_cast<const uint32_t *>(&m);
  uint32_t *dst = reinterpret_cast<uint32_t *>(&o);
#pragma unroll
  for (int w = 0; w < (int)(sizeof(P) / 4); ++w) {
    const uint32_t x = __shfl_xor_sync(PAIR_FULL_MASK, src[w], 1);
    dst[w] = mine ? src[w] : x;
  }
}

// Starts the copy of row ``row`` of two coordinates (tab_x, tab_y: 16 u16
// limbs a coordinate) into rows (x: rows[0..1], y: rows[2..3]; the even
// lane copies x, the odd lane y).
__device__ __forceinline__ void pair_fetch_xy(uint4 rows[4],
                                              const uint16_t *tab_x,
                                              const uint16_t *tab_y,
                                              int32_t row, bool odd) {
  const uint16_t *src = (odd ? tab_y : tab_x) + (int64_t)row * 16;
  cp_async16(&rows[odd ? 2 : 0], src);
  cp_async16(&rows[odd ? 3 : 1], src + 8);
}

// Starts the copy of row ``row`` of an affine table (tab_x, tab_y; tab_ok:
// a flag a row) into rows by pair_fetch_xy and returns the row's flag. The
// pair reads rows after cp_async_wait_all and __syncwarp.
__device__ __forceinline__ uint32_t pair_fetch_row(uint4 rows[4],
                                                   const uint16_t *tab_x,
                                                   const uint16_t *tab_y,
                                                   const uint8_t *tab_ok,
                                                   int32_t row, bool odd) {
  pair_fetch_xy(rows, tab_x, tab_y, row, odd);
  return __ldg(tab_ok + row);
}

// Starts the copy of row ``row`` of a table of three coordinates (tab_a,
// tab_b, tab_c) into rows: a and b by pair_fetch_xy (rows[0..3]), c into
// rows[4..5], the even lane its low half and the odd lane its high half.
// The pair reads rows after cp_async_wait_all and __syncwarp.
__device__ __forceinline__ void pair_fetch_row3(uint4 rows[6],
                                                const uint16_t *tab_a,
                                                const uint16_t *tab_b,
                                                const uint16_t *tab_c,
                                                int32_t row, bool odd) {
  pair_fetch_xy(rows, tab_a, tab_b, row, odd);
  cp_async16(&rows[odd ? 5 : 4], tab_c + (int64_t)row * 16 + (odd ? 8 : 0));
}

// The field element of 32 bytes at r (two 16-byte vectors).
template <class FE>
__device__ __forceinline__ void row_fe(FE &o, const uint4 *r) {
  o.v[0] = r[0].x; o.v[1] = r[0].y; o.v[2] = r[0].z; o.v[3] = r[0].w;
  o.v[4] = r[1].x; o.v[5] = r[1].y; o.v[6] = r[1].z; o.v[7] = r[1].w;
}
