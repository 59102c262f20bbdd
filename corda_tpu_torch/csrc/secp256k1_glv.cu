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
// Design (redesigned for Hopper): two lanes of a warp per signature
// (csrc/lanes.cuh) at every batch size, on the complete a = 0 formulas of
// Renes-Costello-Batina 2016 split between the lanes
// (csrc/curve_k1_pair.cuh: a doubling 4 products deep instead of 8, an
// addition 6 instead of 12) over the Comba field csrc/field_k1_comba.cuh
// (carry chains, a 36-multiply squaring), as B3 and B8 Shamir. The
// 16-entry table of subset sums T[t] = sum of P_j over the set bits j of t
// is built on the pair with 11 complete additions (every t that is not a
// power of two: T[t] = T[t - low] + P_low) and split between the lanes:
// the even lane keeps rows 0-7 and the odd lane rows 8-15 in local memory
// (768 bytes a lane, the one-thread kernel's 1.5 KB a signature), and the
// owner of the selected row hands it to its partner by shuffles. Then 128
// steps of one doubling, a 4-bit select (bit j from scalar j's plane; the
// next step's four planes are loaded while a step runs) and one complete
// addition, 10 products deep; no step is peeled, as in the reference.
// Acceptance puts r*Z and r'*Z one product on each lane and compares
// canonically. Lanes past the ragged edge run the last item again and
// store nothing. 128 threads a block; __launch_bounds__(128, 3): up to 168
// registers a lane. Each block also asks for kResidencySmem bytes of
// dynamic shared memory that it never touches, in a small shared-memory
// carveout, so that at most 2 blocks, 8 warps, are resident on a
// multiprocessor while the L1 keeps 224 KB for the lanes' tables and
// stacks (896 bytes a lane; 30 MB over 132 multiprocessors, well inside
// the 50 MB L2), and a 32768-item batch is exactly two waves. On an H100,
// in turns at 32768 items: 2.13-2.15 ms, against 2.49 at 12 resident
// warps (1.29 waves), 2.31 with 80 KB a block (8 warps, L1 cut to ~92 KB)
// and 10 % more at 16 warps (61 MB of tables, past the L2); the same as
// 12 warps at 16384 items and below (PERF.md). A freshly built library is
// held against the plain version on known answers before its first
// verdict (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field products a signature (b3 * x
// is a small-constant multiply and not counted): table 11 additions x 12
// = 132; 128 x (doubling 6 + 2 squarings, addition 12) = 2304 products and
// 256 squarings; accept 2. Total 2438 products of 64 + 8 32x32->64
// multiplies and 256 squarings of 36 + 8, each multiply 2 IMAD issue
// slots: 2438 x 144 + 256 x 88 = 373,600 IMAD a signature. The pair runs
// exactly these products, none on both lanes (only the b3 multiplies
// repeat).
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1_pair.cuh"

// Wire layout (the JAX kernel's, with pts4 stacked):
//   bits4   (128, n, 4) u8: bit planes of |a|, |b|, |c|, |d|, MSB first
//   pts4    (4, 3, n, 16) u16: the four sign-adjusted points, projective
//   r_cands (2, n, 16) u16: r, and r + n (or r)
static const int kBlock = 128;
// The shared memory of a multiprocessor is set to 32 KB (14 % of its 228
// KB, rounded up to the next capacity the card offers), the rest left to
// the L1 that holds the lanes' tables and stacks; each block asks for 12
// KB (and holds 1 KB more), so no third block fits: 8 resident warps.
static const int kCarveoutPercent = 14;
static const int kResidencySmem = 12 * 1024;

__device__ __forceinline__ int glv_select(uchar4 b) {
  return (b.x != 0) | ((b.y != 0) << 1) | ((b.z != 0) << 2) |
         ((b.w != 0) << 3);
}

__global__ void __launch_bounds__(kBlock, 3) secp256k1_glv_verify_kernel(
    const uint8_t *__restrict__ bits4, const uint16_t *__restrict__ pts4,
    const uint16_t *__restrict__ r_cands, uint8_t *__restrict__ ok,
    int64_t n) {
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;

  // the subset sums, split between the lanes: T[0] the identity, T[2^j]
  // point j, T[t] = T[t - low] + T[low]
  k1pt T[8], a, b;
  k1pt_identity(a);
  pair_row_put(T, 0, a, odd);
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    k1_load16(a.X, pts4 + ((j * 3 + 0) * n + i) * 16);
    k1_load16(a.Y, pts4 + ((j * 3 + 1) * n + i) * 16);
    k1_load16(a.Z, pts4 + ((j * 3 + 2) * n + i) * 16);
    pair_row_put(T, 1 << j, a, odd);
  }
#pragma unroll 1
  for (int t = 3; t < 16; ++t) {
    const int low = t & -t;
    if (low == t) continue;
    pair_row_get(a, T, t ^ low, odd);
    pair_row_get(b, T, low, odd);
    k1pt_add_pair(a, a, b, odd);
    pair_row_put(T, t, a, odd);
  }

  k1pt acc;
  k1pt_identity(acc);
  const uchar4 *planes = reinterpret_cast<const uchar4 *>(bits4);
  int idx = glv_select(planes[i]);
#pragma unroll 1
  for (int t = 0; t < 128; ++t) {
    const int next = t < 127 ? glv_select(planes[(t + 1) * n + i]) : 0;
    k1pt_dbl_pair(acc, acc, odd);
    pair_row_get(a, T, idx, odd);
    k1pt_add_pair(acc, acc, a, odd);
    idx = next;
  }

  // accept: Z != 0 and X == r*Z or X == r'*Z (one product a lane)
  k1fe r, r2, rz, r2z;
  k1_load16(r, r_cands + i * 16);
  k1_load16(r2, r_cands + (n + i) * 16);
  pair_mul<K1Field>(rz, r2z, r, acc.Z, r2, acc.Z, odd);
  const bool hit = k1_eq(acc.X, rz) || k1_eq(acc.X, r2z);
  if (item < n && !odd) ok[i] = (!k1_is_zero(acc.Z) && hit) ? 1 : 0;
}

// Sets the kernel's preferred shared-memory carveout (kCarveoutPercent).
static cudaError_t set_carveout() {
  return cudaFuncSetAttribute(secp256k1_glv_verify_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              kCarveoutPercent);
}

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int secp256k1_glv_verify(const void *bits4, const void *pts4,
                         const void *r_cands, void *ok, int64_t n,
                         void *stream) {
  if (n <= 0) return 0;
  const cudaError_t rc = set_carveout();
  if (rc != cudaSuccess) return (int)rc;
  const int64_t blocks = (n * 2 + kBlock - 1) / kBlock;
  secp256k1_glv_verify_kernel<<<(unsigned)blocks, kBlock, kResidencySmem,
                                (cudaStream_t)stream>>>(
      (const uint8_t *)bits4, (const uint16_t *)pts4,
      (const uint16_t *)r_cands, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor at ``block`` threads a block and the
// launch's dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int secp256k1_glv_occupancy(int block) {
  int blocks = 0;
  return set_carveout() == cudaSuccess &&
                 cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, secp256k1_glv_verify_kernel, block,
                     kResidencySmem) == cudaSuccess
             ? blocks
             : -1;
}

int secp256k1_glv_block(void) { return kBlock; }

// Lanes (threads) a signature.
int secp256k1_glv_lanes(void) { return 2; }

const char *secp256k1_glv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
