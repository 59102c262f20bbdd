// Ed25519 batch verification by the 256-step Shamir ladder on Hopper
// (kernel B7, Shamir).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core (with
// shamir_ladder, _select4, add and double). Per item it computes
// X = [s]B + [k](-A) by interleaved double-and-add over the MSB-first bits
// of s and k, and accepts by projective equality against the host-decoded
// affine R: X.X == Rx * X.Z and X.Y == Ry * X.Z, compared canonically.
//
// Design: one thread per signature, as B2; the field is field25519.cuh and
// the point formulas curve_ed25519.cuh. The four addends {O, B, -A, B - A}
// live in a per-thread table (local memory, 512 bytes) indexed by
// s_bit + 2 k_bit; B - A is one complete addition before the ladder. Every
// step is a doubling and a complete addition (of the identity for a zero
// digit pair), so there are no data-dependent branches.
//
// Bound: integer multiply throughput. Field multiplications or squarings
// per signature: B - A 9; 256 doublings x (4 squarings + 4 products); 256
// additions x 9; acceptance 2 products. Total 3339 products and 1024
// squarings. A product needs 64 + 8 wide 32x32->64 multiplies, a squaring
// 36 + 8 (triangular; fe_sqr here still spends 64 + 8), each counted as 2
// IMAD issue slots: 3339 x 144 + 1024 x 88 = 570,928 IMAD a signature.
// Bytes per signature: 512 of bit planes, 128 of -A, 64 of R, 1 verdict.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_ed25519.cuh"

// The base point B in extended coordinates: x, y, z = 1, t = x y.
__device__ __constant__ uint32_t ED_BX[8] = {
    0x8f25d51au, 0xc9562d60u, 0x9525a7b2u, 0x692cc760u,
    0xfdd6dc5cu, 0xc0a4e231u, 0xcd6e53feu, 0x216936d3u};
__device__ __constant__ uint32_t ED_BY[8] = {
    0x66666658u, 0x66666666u, 0x66666666u, 0x66666666u,
    0x66666666u, 0x66666666u, 0x66666666u, 0x66666666u};
__device__ __constant__ uint32_t ED_BT[8] = {
    0xa5b7dda3u, 0x6dde8ab3u, 0x775152f5u, 0x20f09f80u,
    0x64abe37du, 0x66ea4e8eu, 0xd78b7665u, 0x67875f0fu};

__device__ __forceinline__ bool fe_equal_canon(const fe &a, const fe &b) {
  fe ca, cb;
  fe_canon(ca, a);
  fe_canon(cb, b);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= ca.v[k] ^ cb.v[k];
  return diff == 0;
}

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   s_bits, k_bits (256, n) u8: MSB-first bit planes of s and k
//   ax, ay, az, at (n, 16) u16: -A in extended coordinates
//   rx, ry         (n, 16) u16: R affine, canonical
__global__ void __launch_bounds__(128) ed25519_shamir_verify_kernel(
    const uint8_t *__restrict__ s_bits, const uint8_t *__restrict__ k_bits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ rx, const uint16_t *__restrict__ ry,
    uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  ge pts[4];
  ge_identity(pts[0]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    pts[1].X.v[k] = ED_BX[k];
    pts[1].Y.v[k] = ED_BY[k];
    pts[1].T.v[k] = ED_BT[k];
  }
  fe_one(pts[1].Z);
  fe_load16(pts[2].X, ax + i * 16);
  fe_load16(pts[2].Y, ay + i * 16);
  fe_load16(pts[2].Z, az + i * 16);
  fe_load16(pts[2].T, at + i * 16);
  ge_add(pts[3], pts[1], pts[2]);

  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int b = 0; b < 256; ++b) {
    const int sel = (s_bits[b * n + i] & 1) | ((k_bits[b * n + i] & 1) << 1);
    ge_double(acc, acc);
    ge_add(acc, acc, pts[sel]);
  }

  fe r, t;
  fe_load16(r, rx + i * 16);
  fe_mul(t, r, acc.Z);
  const bool ok_x = fe_equal_canon(acc.X, t);
  fe_load16(r, ry + i * 16);
  fe_mul(t, r, acc.Z);
  const bool ok_y = fe_equal_canon(acc.Y, t);
  ok[i] = (ok_x && ok_y) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int ed25519_shamir_verify(const void *s_bits, const void *k_bits,
                          const void *ax, const void *ay, const void *az,
                          const void *at, const void *rx, const void *ry,
                          void *ok, int64_t n, void *stream) {
  if (n <= 0) return 0;
  const int threads = kBlock;
  const int64_t blocks = (n + threads - 1) / threads;
  ed25519_shamir_verify_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      (const uint8_t *)s_bits, (const uint8_t *)k_bits,
      (const uint16_t *)ax, (const uint16_t *)ay, (const uint16_t *)az,
      (const uint16_t *)at, (const uint16_t *)rx, (const uint16_t *)ry,
      (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the kernel at ``block`` threads a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int ed25519_shamir_occupancy(int block) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ed25519_shamir_verify_kernel, block, 0) != cudaSuccess)
    return -1;
  return blocks;
}

int ed25519_shamir_block(void) { return kBlock; }

int ed25519_shamir_lanes(void) { return kLanes; }

const char *ed25519_shamir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
