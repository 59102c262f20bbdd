// Ed25519 batch verification by the windowed constant-B ladder on Hopper
// (kernel B7, windowed).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core_windowed
// (with windowed_ladder, _select4, madd_niels, add and double). Per item it
// computes [s]B + [k](-A) with w = 16 windows of s read from a 2^16-row
// Niels table of B and 2-bit digits of k over {O, -A, -2A, -3A}, and
// accepts by RFC 8032 re-encoding: after one Fermat inversion the canonical
// affine y must equal the wire y and x's parity the wire sign bit.
//
// Design: one thread per signature, as B2; the field is field25519.cuh and
// the point formulas curve_ed25519.cuh. The per-item digit table
// {O, -A, -2A, -3A} (one doubling, one addition) lives in local memory
// (512 bytes); the B table is 3 x (65536, 16) u16 = 6 MB, read from global
// memory through the 50 MB L2 (it is B2's low table, the same bytes). Step
// 0 is peeled: the accumulator starts as the first digit's addend. Each
// outer step is 8 x (2 doublings + 1 addition) and one Niels mixed addition.
//
// Bound: integer multiply throughput. Field multiplications or squarings
// per signature: digit table 1 doubling (4 + 4) and 1 addition (9); 254
// ladder doublings x (4 squarings + 4 products) and 127 additions x 9; 16
// Niels additions x 7; inversion 254 squarings + 11 products and two affine
// products. Total 2297 products and 1274 squarings. A product needs 64 + 8
// wide 32x32->64 multiplies, a squaring 36 + 8 (triangular; fe_sqr here
// still spends 64 + 8), each counted as 2 IMAD issue slots:
// 2297 x 144 + 1274 x 88 = 442,880 IMAD a signature. Bytes per signature:
// 64 of windows, 128 of digits, 128 of -A, 32 of R y, 1 of sign, 1 verdict,
// plus each distinct Niels row gathered (96 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_ed25519.cuh"

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   b_idx          (16, n) i32: w = 16 windows of s, MSB first
//   a_digits       (16, 8, n) u8: 2-bit digits of k, MSB first
//   ax, ay, az, at (n, 16) u16: -A in extended coordinates
//   r_y            (n, 16) u16: wire R y (canonical, host range-checked)
//   r_sign         (n,) u8: wire R sign bit
//   tp, tm, ttd    (65536, 16) u16: (y+x, y-x, 2dxy) of [j]B
__global__ void __launch_bounds__(128) ed25519_windowed_verify_kernel(
    const int32_t *__restrict__ b_idx, const uint8_t *__restrict__ a_digits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ r_y, const uint8_t *__restrict__ r_sign,
    const uint16_t *__restrict__ tp, const uint16_t *__restrict__ tm,
    const uint16_t *__restrict__ ttd, uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  ge tab[4];
  ge_identity(tab[0]);
  fe_load16(tab[1].X, ax + i * 16);
  fe_load16(tab[1].Y, ay + i * 16);
  fe_load16(tab[1].Z, az + i * 16);
  fe_load16(tab[1].T, at + i * 16);
  ge_double(tab[2], tab[1]);
  ge_add(tab[3], tab[2], tab[1]);

  // digit (step, m) of k sits at a_digits[(step * 8 + m) * n + i]
  ge acc = tab[a_digits[i] & 3];
#pragma unroll 1
  for (int d = 1; d < 128; ++d) {
    if ((d & 7) == 0) {
      ge_madd_niels(acc, tp, tm, ttd, b_idx[(int64_t)((d >> 3) - 1) * n + i]);
    }
    ge_double(acc, acc);
    ge_double(acc, acc);
    ge_add(acc, acc, tab[a_digits[(int64_t)d * n + i] & 3]);
  }
  ge_madd_niels(acc, tp, tm, ttd, b_idx[15 * n + i]);

  fe zi, x, y, r;
  fe_inv(zi, acc.Z);
  fe_mul(x, acc.X, zi);
  fe_mul(y, acc.Y, zi);
  fe_canon(x, x);
  fe_canon(y, y);
  fe_load16(r, r_y + i * 16);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= y.v[k] ^ r.v[k];
  ok[i] = (diff == 0 && (x.v[0] & 1u) == (uint32_t)(r_sign[i] & 1)) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int ed25519_windowed_verify(const void *b_idx, const void *a_digits,
                            const void *ax, const void *ay, const void *az,
                            const void *at, const void *r_y,
                            const void *r_sign, const void *tp,
                            const void *tm, const void *ttd, void *ok,
                            int64_t n, void *stream) {
  if (n <= 0) return 0;
  const int threads = kBlock;
  const int64_t blocks = (n + threads - 1) / threads;
  ed25519_windowed_verify_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t *)b_idx, (const uint8_t *)a_digits,
      (const uint16_t *)ax, (const uint16_t *)ay, (const uint16_t *)az,
      (const uint16_t *)at, (const uint16_t *)r_y, (const uint8_t *)r_sign,
      (const uint16_t *)tp, (const uint16_t *)tm, (const uint16_t *)ttd,
      (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the kernel at ``block`` threads a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int ed25519_windowed_occupancy(int block) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ed25519_windowed_verify_kernel, block, 0) != cudaSuccess)
    return -1;
  return blocks;
}

int ed25519_windowed_block(void) { return kBlock; }

int ed25519_windowed_lanes(void) { return kLanes; }

const char *ed25519_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
