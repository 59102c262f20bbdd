// secp256k1 batch ECDSA verification by the GLV joint ladder on Hopper
// (kernel B8, glv mode).
//
// Replaces the TPU kernel corda_tpu/ops/weierstrass.py:verify_core_glv
// (with glv_ladder, add, dbl and _accept). The host has split
// u1 = a + b*lambda and u2 = c + d*lambda (every half below 2^128) and
// flipped the base point of each negative half; per item the kernel
// computes [|a|](+-G) + [|b|](+-phi(G)) + [|c|](+-Q) + [|d|](+-phi(Q)) and
// accepts when Z != 0 and X == r*Z or X == r'*Z for the two host
// candidates.
//
// Design: one thread per signature; points and formulas from
// csrc/curve_k1.cuh (complete a = 0 RCB16). The 16-entry table of subset
// sums T[t] = sum of P_j over the set bits j of t is built with 11
// complete additions (every t that is not a power of two: T[t] =
// T[t - low] + P_low) and lives in local memory (1.5 KB a thread). Then
// 128 steps of one doubling, a 4-bit select (bit j from scalar j's plane)
// and one complete addition; no step is peeled, as in the reference.
//
// Bound: integer multiply throughput. Field products a signature: table
// 11 additions x 12 = 132; 128 x (doubling 6 + 2 squarings, addition 12)
// = 2304 products and 256 squarings; accept 2. Total 2438 products of
// 64 + 8 32x32->64 multiplies and 256 squarings of 36 + 8, each multiply 2
// IMAD issue slots: 2438 x 144 + 256 x 88 = 373,600 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1.cuh"

// One thread per item. Wire layout (the JAX kernel's, with pts4 stacked):
//   bits4   (128, n, 4) u8: bit planes of |a|, |b|, |c|, |d|, MSB first
//   pts4    (4, 3, n, 16) u16: the four sign-adjusted points, projective
//   r_cands (2, n, 16) u16: r, and r + n (or r)
__global__ void __launch_bounds__(128) secp256k1_glv_verify_kernel(
    const uint8_t *__restrict__ bits4, const uint16_t *__restrict__ pts4,
    const uint16_t *__restrict__ r_cands, uint8_t *__restrict__ ok,
    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  k1pt T[16];
  k1pt_identity(T[0]);
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    k1pt &P = T[1 << j];
    k1_load16(P.X, pts4 + ((j * 3 + 0) * n + i) * 16);
    k1_load16(P.Y, pts4 + ((j * 3 + 1) * n + i) * 16);
    k1_load16(P.Z, pts4 + ((j * 3 + 2) * n + i) * 16);
  }
#pragma unroll 1
  for (int t = 3; t < 16; ++t) {
    const int low = t & -t;
    if (low != t) k1pt_add(T[t], T[t ^ low], T[low]);
  }

  k1pt acc;
  k1pt_identity(acc);
  const uchar4 *planes = reinterpret_cast<const uchar4 *>(bits4);
#pragma unroll 1
  for (int t = 0; t < 128; ++t) {
    const uchar4 b = planes[t * n + i];
    const int idx = (b.x != 0) | ((b.y != 0) << 1) | ((b.z != 0) << 2) |
                    ((b.w != 0) << 3);
    k1pt_dbl(acc, acc);
    k1pt_add(acc, acc, T[idx]);
  }

  // accept: Z != 0 and X == r*Z or X == r'*Z
  k1fe r, rz;
  k1_load16(r, r_cands + i * 16);
  k1_mul(rz, r, acc.Z);
  bool hit = k1_eq(acc.X, rz);
  k1_load16(r, r_cands + (n + i) * 16);
  k1_mul(rz, r, acc.Z);
  hit = hit || k1_eq(acc.X, rz);
  ok[i] = (!k1_is_zero(acc.Z) && hit) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int secp256k1_glv_verify(const void *bits4, const void *pts4,
                         const void *r_cands, void *ok, int64_t n,
                         void *stream) {
  if (n <= 0) return 0;
  const int threads = kBlock;
  const int64_t blocks = (n + threads - 1) / threads;
  secp256k1_glv_verify_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t *)bits4, (const uint16_t *)pts4,
      (const uint16_t *)r_cands, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the kernel at ``block`` threads a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int secp256k1_glv_occupancy(int block) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, secp256k1_glv_verify_kernel, block, 0) != cudaSuccess)
    return -1;
  return blocks;
}

int secp256k1_glv_block(void) { return kBlock; }

int secp256k1_glv_lanes(void) { return kLanes; }

const char *secp256k1_glv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
