// secp256k1 hybrid-GLV batch ECDSA verification on Hopper (kernel B3).
//
// Replaces the TPU kernel corda_tpu/ops/weierstrass.py:verify_core_hybrid_wide
// (with hybrid_ladder_wide, _q_window_table, select_tree, _add_k1, _madd_k1,
// dbl and _accept_rn). Per item it computes
// [a]G + [b]phi(G) + [c]Qc + [d]Qd over 128-bit GLV halves: the G legs come
// from the constant affine table, indexed by 8-bit digits of |a| and |b| and
// their signs (one gathered row a step), the Q legs from a 16-entry per-item
// table T[i + 4j] = [i]Qc + [j]Qd selected by 2-bit digits. It accepts when
// Z != 0 and X == r*Z, or rn_ok and X == (r + n)*Z (projective x == r).
//
// Design: one thread per signature; the field is csrc/field_k1.cuh (8 x
// 32-bit words, 64 32x32->64 multiply-adds a product). Points are projective
// (X:Y:Z) with the complete a = 0 formulas of Renes-Costello-Batina 2016
// (Algorithms 7, 8 and 9, b3 = 21; csrc/curve_k1.cuh, shared with B5 and
// B8), so there are no data-dependent branches;
// the peeled first step may select T[0], the identity (0:1:0), which the
// complete formulas take as they take any point. The mixed addition is not
// valid for an identity addend, so the table's identity rows (flag 0) keep
// the accumulator instead (a select, as the JAX kernel's g_add). The joint
// table lives in local memory (1.5 KB a thread); the table rows of the
// 2^18-entry G table (17 MB with its flags, resident in the 50 MB L2) are
// gathered from global memory.
//
// Bound: integer multiply throughput. Field products a signature (b3 * x
// is a small-constant multiply and not counted): joint table 2 doublings x
// (6 + 2 squarings) + 11 mixed additions x 11 = 133 products and 4
// squarings; 63 Q steps x (2 doublings + 1 addition x 12) = 756 + 756
// products and 252 squarings; 16 mixed G additions x 11 = 176; accept 2.
// Total 1823 products of 64 + 8 32x32->64 multiplies and 256 squarings of
// 36 + 8 (triangular; k1_sqr here still spends 64 + 8), each counted as 2
// IMAD issue slots: 1823 x 144 + 256 x 88 = 285,040 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1.cuh"

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   g_idx   (16, n) i32: G-table index of outer step s (18 bits); row 0
//           carries rn_ok at bit 18
//   q_bits  (16, 4, n) u8: joint Q digits wc | wd << 2, MSB first
//   pts     (n, 4, 16) u16: Qc x, Qc y, Qd x, Qd y (affine, canonical)
//   r_limbs (n, 16) u16: r
//   tables  tab_x, tab_y (2^18, 16) u16 and tab_ok (2^18,) u8
__global__ void __launch_bounds__(128) secp256k1_hybrid_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_bits,
    const uint16_t *__restrict__ pts, const uint16_t *__restrict__ r_limbs,
    const uint16_t *__restrict__ tab_x, const uint16_t *__restrict__ tab_y,
    const uint8_t *__restrict__ tab_ok, uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  k1fe qcx, qcy, qdx, qdy;
  const uint16_t *row = pts + i * 64;
  k1_load16(qcx, row);
  k1_load16(qcy, row + 16);
  k1_load16(qdx, row + 32);
  k1_load16(qdy, row + 48);
  k1pt T[16];
  k1pt_identity(T[0]);
  T[1].X = qcx; T[1].Y = qcy; k1_one(T[1].Z);
  k1pt_dbl(T[2], T[1]);
  k1pt_madd(T[3], T[2], qcx, qcy);
  T[4].X = qdx; T[4].Y = qdy; k1_one(T[4].Z);
  k1pt_dbl(T[8], T[4]);
  k1pt_madd(T[12], T[8], qdx, qdy);
#pragma unroll 1
  for (int j = 4; j <= 12; j += 4) {
#pragma unroll 1
    for (int k = 1; k <= 3; ++k) k1pt_madd(T[j + k], T[j + k - 1], qcx, qcy);
  }

  const int32_t g0 = g_idx[i];
  const bool rn_ok = (g0 >> 18) & 1;
  // outer step s: 4 x (2 doublings + 1 Q add), then one G add; step 0
  // starts from the identity, so its first Q add is the entry itself
  k1pt acc = T[q_bits[i] & 15];
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
      k1pt_dbl(acc, acc);
      k1pt_dbl(acc, acc);
      k1pt_add(acc, acc, T[q_bits[(s * 4 + k) * n + i] & 15]);
    }
    const int32_t gi = (s == 0) ? (g0 & ((1 << 18) - 1)) : g_idx[s * n + i];
    k1_g_add(acc, tab_x, tab_y, tab_ok, gi);
  }

  // accept: Z != 0 and X == r*Z or, where r + n < p, X == (r + n)*Z
  k1fe r, rn, nn, rz;
  k1_load16(r, r_limbs + i * 16);
#pragma unroll
  for (int k = 0; k < 8; ++k) nn.v[k] = K1_N[k];
  k1_add(rn, r, nn);
  k1_mul(rz, r, acc.Z);
  bool hit = k1_eq(acc.X, rz);
  k1_mul(rz, rn, acc.Z);
  hit = hit || (rn_ok && k1_eq(acc.X, rz));
  ok[i] = (!k1_is_zero(acc.Z) && hit) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int secp256k1_hybrid_verify(const void *g_idx, const void *q_bits,
                            const void *pts, const void *r_limbs,
                            const void *tab_x, const void *tab_y,
                            const void *tab_ok, void *ok, int64_t n,
                            void *stream) {
  if (n <= 0) return 0;
  const int threads = kBlock;
  const int64_t blocks = (n + threads - 1) / threads;
  secp256k1_hybrid_verify_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t *)g_idx, (const uint8_t *)q_bits, (const uint16_t *)pts,
      (const uint16_t *)r_limbs, (const uint16_t *)tab_x,
      (const uint16_t *)tab_y, (const uint8_t *)tab_ok, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the kernel at ``block`` threads a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int secp256k1_hybrid_occupancy(int block) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, secp256k1_hybrid_verify_kernel, block, 0) != cudaSuccess)
    return -1;
  return blocks;
}

int secp256k1_hybrid_block(void) { return kBlock; }

int secp256k1_hybrid_lanes(void) { return kLanes; }

const char *secp256k1_hybrid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
