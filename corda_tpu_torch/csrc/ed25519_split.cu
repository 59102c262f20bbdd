// Ed25519 split-k batch verification on Hopper (kernel B2).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core_split (with
// split_ladder, _joint_a_table, madd_niels, add and double). Per item it
// computes [s_lo]B + [s_hi]B' + [k_lo](-A) + [k_hi](-A') over 128-bit
// scalar halves (B' = [2^128]B, A' = [2^128]A) and accepts by RFC 8032
// re-encoding: after one Fermat inversion the canonical affine y must equal
// the wire y and x's parity the wire sign bit.
//
// Design: one thread per signature; the field is csrc/field25519.cuh
// (8 x 32-bit words, 64 32x32->64 multiply-adds per product). The 16-entry
// joint table T[i + 4j] = [i](-A) + [j](-A') lives in local memory (2 KB a
// thread) because it is indexed by a per-item digit; the Niels rows of the
// two constant tables (6 x 2 MB, resident in the 50 MB L2) are gathered from
// global memory. Formulas are the complete ones of the JAX kernel, so there
// are no data-dependent branches: every item runs the same ladder.
//
// Bound: integer multiply throughput. Field multiplications or squarings per
// signature: joint table 2 doublings x 8 + 11 additions x 9 = 115; 63
// a-steps x (2 doublings x 8 + 1 addition x 9) = 1575 (the first of the 64
// a-steps starts from the identity and is a table select); 16 Niels mixed
// additions x 7 = 112; inversion 254 + 11 plus two affine products = 267.
// Total 2069, of which 766 are squarings (4 in each of the 128 doublings,
// 254 in the inversion) and 1303 products. A product needs 64 + 8 wide
// 32x32->64 multiplies (the 512-bit product and its fold), a squaring
// 36 + 8 (triangular; fe_sqr here still spends 64 + 8), each counted as 2
// IMAD issue slots: 1303 x 144 + 766 x 88 = 255,040 IMAD a signature.
//
// Registers and local memory (nvcc -Xptxas -v, sm_90a, printed by
// chip_smoke.py at build time): 78 registers, a 2432-byte stack frame (the
// joint table), no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

struct ge {
  fe X, Y, Z, T;
};

__device__ __forceinline__ void ge_identity(ge &o) {
  fe_zero(o.X);
  fe_one(o.Y);
  fe_one(o.Z);
  fe_zero(o.T);
}

// Unified extended addition (add-2008-hwcd-3, a = -1, k = 2d): 9 products.
__device__ __noinline__ void ge_add(ge &o, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, b, t);
  fe d2;
#pragma unroll
  for (int i = 0; i < 8; ++i) d2.v[i] = FE_D2[i];
  fe_mul(c, p.T, d2);
  fe_mul(c, c, q.T);
  fe_mul(d, p.Z, q.Z);
  fe_mul_small(d, d, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(o.X, e, f);
  fe_mul(o.Y, g, h);
  fe_mul(o.Z, f, g);
  fe_mul(o.T, e, h);
}

// Doubling (dbl-2008-hwcd): 4 squarings + 4 products.
__device__ __noinline__ void ge_double(ge &o, const ge &p) {
  fe a, b, c, e, f, g, h, t;
  fe_sqr(a, p.X);
  fe_sqr(b, p.Y);
  fe_sqr(c, p.Z);
  fe_mul_small(c, c, 2);
  fe_add(h, a, b);
  fe_add(t, p.X, p.Y);
  fe_sqr(t, t);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(o.X, e, f);
  fe_mul(o.Y, g, h);
  fe_mul(o.Z, f, g);
  fe_mul(o.T, e, h);
}

__device__ __forceinline__ void fe_load16(fe &o, const uint16_t *src) {
  const uint4 *s = reinterpret_cast<const uint4 *>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  o.v[0] = lo.x; o.v[1] = lo.y; o.v[2] = lo.z; o.v[3] = lo.w;
  o.v[4] = hi.x; o.v[5] = hi.y; o.v[6] = hi.z; o.v[7] = hi.w;
}

// Mixed addition of the Niels row (y+x, y-x, 2dxy) of a constant table,
// Z2 = 1: 7 products. Complete for every accumulator; row 0 is (1, 1, 0).
__device__ __noinline__ void ge_madd_niels(ge &acc, const uint16_t *tp,
                                           const uint16_t *tm,
                                           const uint16_t *ttd, int row) {
  fe yp, ym, td, a, b, c, d, e, f, g, h;
  const int64_t off = (int64_t)(row & 0xFFFF) * 16;
  fe_load16(yp, tp + off);
  fe_load16(ym, tm + off);
  fe_load16(td, ttd + off);
  fe_sub(a, acc.Y, acc.X);
  fe_mul(a, a, ym);
  fe_add(b, acc.Y, acc.X);
  fe_mul(b, b, yp);
  fe_mul(c, acc.T, td);
  fe_mul_small(d, acc.Z, 2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(acc.X, e, f);
  fe_mul(acc.Y, g, h);
  fe_mul(acc.Z, f, g);
  fe_mul(acc.T, e, h);
}

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   bb_idx   (16, n) i32: rows 0-7 B-table windows, rows 8-15 B'-table
//   a_packed (8, 8, n) u8: joint digits k_lo | k_hi << 2, MSB first
//   rows     (n, 6, 16) u16: -A (x, y, t), -A' (x, y, t), canonical limbs
//   r_packed (n, 16) u16: wire R y with its sign bit at limb 15 bit 15
//   tables   6 x (65536, 16) u16: (y+x, y-x, 2dxy) for B, then for B'
__global__ void __launch_bounds__(128) ed25519_split_verify_kernel(
    const int32_t *__restrict__ bb_idx, const uint8_t *__restrict__ a_packed,
    const uint16_t *__restrict__ rows, const uint16_t *__restrict__ r_packed,
    const uint16_t *__restrict__ tp, const uint16_t *__restrict__ tm,
    const uint16_t *__restrict__ ttd, const uint16_t *__restrict__ t2p,
    const uint16_t *__restrict__ t2m, const uint16_t *__restrict__ t2td,
    uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  ge T[16];
  ge_identity(T[0]);
  const uint16_t *row = rows + i * 96;
  fe_load16(T[1].X, row);
  fe_load16(T[1].Y, row + 16);
  fe_one(T[1].Z);
  fe_load16(T[1].T, row + 32);
  fe_load16(T[4].X, row + 48);
  fe_load16(T[4].Y, row + 64);
  fe_one(T[4].Z);
  fe_load16(T[4].T, row + 80);
  ge_double(T[2], T[1]);
  ge_add(T[3], T[2], T[1]);
  ge_double(T[8], T[4]);
  ge_add(T[12], T[8], T[4]);
#pragma unroll 1
  for (int j = 4; j <= 12; j += 4) {
#pragma unroll 1
    for (int k = 1; k <= 3; ++k) ge_add(T[j + k], T[j + k - 1], T[1]);
  }

  // a-step s (0..63) reads digit a_packed[s / 8][s % 8]; step 0 starts from
  // the identity, so it is the table entry itself.
  ge acc = T[a_packed[i] & 15];
#pragma unroll 1
  for (int s = 1; s < 64; ++s) {
    if ((s & 7) == 0) {
      const int j = (s >> 3) - 1;
      ge_madd_niels(acc, tp, tm, ttd, bb_idx[j * n + i]);
      ge_madd_niels(acc, t2p, t2m, t2td, bb_idx[(8 + j) * n + i]);
    }
    ge_double(acc, acc);
    ge_double(acc, acc);
    ge_add(acc, acc, T[a_packed[s * n + i] & 15]);
  }
  ge_madd_niels(acc, tp, tm, ttd, bb_idx[7 * n + i]);
  ge_madd_niels(acc, t2p, t2m, t2td, bb_idx[15 * n + i]);

  fe zi, x, y;
  fe_inv(zi, acc.Z);
  fe_mul(x, acc.X, zi);
  fe_mul(y, acc.Y, zi);
  fe_canon(x, x);
  fe_canon(y, y);
  fe r;
  fe_load16(r, r_packed + i * 16);
  const uint32_t sign = r.v[7] >> 31;
  r.v[7] &= 0x7FFFFFFFu;
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= y.v[k] ^ r.v[k];
  ok[i] = (diff == 0 && (x.v[0] & 1u) == sign) ? 1 : 0;
}

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int ed25519_split_verify(const void *bb_idx, const void *a_packed,
                         const void *rows, const void *r_packed,
                         const void *tp, const void *tm, const void *ttd,
                         const void *t2p, const void *t2m, const void *t2td,
                         void *ok, int64_t n, void *stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  ed25519_split_verify_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t *)bb_idx, (const uint8_t *)a_packed,
      (const uint16_t *)rows, (const uint16_t *)r_packed,
      (const uint16_t *)tp, (const uint16_t *)tm, (const uint16_t *)ttd,
      (const uint16_t *)t2p, (const uint16_t *)t2m, (const uint16_t *)t2td,
      (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

const char *ed25519_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
