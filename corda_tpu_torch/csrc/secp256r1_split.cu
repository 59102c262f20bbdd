// secp256r1 half-gcd split batch ECDSA verification on Hopper (kernel B4).
//
// Replaces the TPU kernel corda_tpu/ops/weierstrass.py:verify_core_r1_split
// (with r1_split_ladder, _q_table_single, select_tree, _add_m3, _dbl_m3 and
// _madd_w). The host (native sm_r1_prep_hg) has turned u1, u2 into
// W2 = [t_lo]G + [t_hi]G' + [|v1|](+-Q) with every scalar below 2^128
// (G' = [2^128]G) and computed x_D = x([v2]R); per item the kernel
// computes W2 and accepts when Z != 0 and X == x_D * Z.
//
// Design: one thread per signature; the field is csrc/field_p256.cuh (8 x
// 32-bit words, FIPS 186-4 fast reduction). Points are projective (X:Y:Z)
// with the complete a = -3 formulas of Renes-Costello-Batina 2016
// (Algorithms 4, 5 and 6; csrc/curve_p256.cuh, shared with B5 and B8), so
// there are no data-dependent branches; the
// peeled first step may select T[0], the identity (0:1:0). Per outer step
// (8 of them): 4 x (4 doublings + 1 Q add from the 16-entry per-item table
// {0..15}Q in local memory, 1.5 KB a thread), then a mixed add from the G'
// table and one from the G table (two 2^16-row affine tables of 4.2 MB
// each, resident in L2); their identity rows (flag 0) keep the accumulator.
//
// Bound: integer multiply throughput. Field products a signature (b is a
// full-width constant, so b * x counts as a product): Q table 7 doublings x
// (10 + 3 squarings) + 7 mixed additions x 13 = 161 products and 21
// squarings; 31 Q steps x (4 doublings + 1 addition x 14) = 1240 + 434
// products and 372 squarings; 16 mixed G additions x 13 = 208; accept 1.
// Total 2044 products of 64 32x32->64 multiplies and 393 squarings of 36
// (the fast reduction only adds and subtracts words), each counted as 2
// IMAD issue slots: 2044 x 128 + 393 x 72 = 289,928 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_p256.cuh"

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   g_idx    (8, 2, n) i32: [s][0] t_hi window (G' table), [s][1] t_lo
//            window (G table), 16 bits each, MSB first
//   q_digits (8, 4, n) u8: 4-bit |v1| digits, MSB first
//   q_x, q_y (n, 16) u16: Q affine, y sign-adjusted on the host
//   xd       (n, 16) u16: x([v2]R)
//   tables   lo (G) and hi (G') triples: x, y (2^16, 16) u16, ok (2^16,) u8
__global__ void __launch_bounds__(128) secp256r1_split_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_digits,
    const uint16_t *__restrict__ q_x, const uint16_t *__restrict__ q_y,
    const uint16_t *__restrict__ xd, const uint16_t *__restrict__ lo_x,
    const uint16_t *__restrict__ lo_y, const uint8_t *__restrict__ lo_ok,
    const uint16_t *__restrict__ hi_x, const uint16_t *__restrict__ hi_y,
    const uint8_t *__restrict__ hi_ok, uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  p256fe qx, qy;
  p256_load16(qx, q_x + i * 16);
  p256_load16(qy, q_y + i * 16);
  r1pt T[16];
  r1pt_identity(T[0]);
  T[1].X = qx; T[1].Y = qy; p256_one(T[1].Z);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    if (k & 1)
      r1pt_madd(T[k], T[k - 1], qx, qy);
    else
      r1pt_dbl(T[k], T[k >> 1]);
  }

  // outer step s: 4 x (4 doublings + 1 Q add), then the G' and G adds;
  // step 0 starts from the identity, so its first Q add is the entry itself
  r1pt acc = T[q_digits[i] & 15];
#pragma unroll 1
  for (int s = 0; s < 8; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) r1pt_dbl(acc, acc);
      r1pt_add(acc, acc, T[q_digits[(s * 4 + k) * n + i] & 15]);
    }
    r1_g_add(acc, hi_x, hi_y, hi_ok, g_idx[(s * 2) * n + i]);
    r1_g_add(acc, lo_x, lo_y, lo_ok, g_idx[(s * 2 + 1) * n + i]);
  }

  // accept: Z != 0 and X == x_D * Z
  p256fe d, dz;
  p256_load16(d, xd + i * 16);
  p256_mul(dz, d, acc.Z);
  ok[i] = (!p256_is_zero(acc.Z) && p256_eq(acc.X, dz)) ? 1 : 0;
}

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int secp256r1_split_verify(const void *g_idx, const void *q_digits,
                           const void *q_x, const void *q_y, const void *xd,
                           const void *lo_x, const void *lo_y,
                           const void *lo_ok, const void *hi_x,
                           const void *hi_y, const void *hi_ok, void *ok,
                           int64_t n, void *stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  secp256r1_split_verify_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t *)g_idx, (const uint8_t *)q_digits,
      (const uint16_t *)q_x, (const uint16_t *)q_y, (const uint16_t *)xd,
      (const uint16_t *)lo_x, (const uint16_t *)lo_y,
      (const uint8_t *)lo_ok, (const uint16_t *)hi_x,
      (const uint16_t *)hi_y, (const uint8_t *)hi_ok, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

const char *secp256r1_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
