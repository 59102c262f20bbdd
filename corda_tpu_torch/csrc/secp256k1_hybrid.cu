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
// Design (redesigned for Hopper): two lanes of a warp per signature
// (csrc/lanes.cuh), at every batch size: at 32768 signatures too they beat
// the earlier one-thread kernel (PERF.md §6). Points are projective (X:Y:Z)
// with the complete a = 0 formulas of Renes-Costello-Batina 2016
// (Algorithms 7, 8 and 9, b3 = 21), so there are no data-dependent
// branches; the peeled first step may select T[0], the identity (0:1:0),
// which the complete formulas take as they take any point. The mixed
// addition is not valid for an identity addend, so the G table's identity
// rows (flag 0) keep the accumulator instead (a select, as the JAX
// kernel's g_add). Both lanes hold the accumulator; each layer of
// independent products in the formulas (csrc/curve_k1_pair.cuh) is split
// between them and exchanged with __shfl_xor_sync, so a doubling runs 4
// products deep instead of 8 and an addition 6 instead of 12. The field is
// csrc/field_k1_comba.cuh: Comba products and the fold by 2^32 + 977 on
// PTX carry chains (csrc/carry.cuh), a 36-multiply squaring. The joint
// table is split between the lanes: the even lane keeps rows 0-7 and the
// odd lane rows 8-15 in local memory (768 bytes a lane, the earlier
// one-thread kernel's 1.5 KB a signature), and the owner of the selected
// row hands it to its partner by shuffles. The rows of the 2^18-entry G
// table (17 MB with its flags) are resident in the 50 MB L2; the next
// outer step's row is copied into shared memory with cp.async (the even
// lane x, the odd lane y) while the step's 8 doublings and 4 Q additions
// run, so its L2 latency leaves the chain. 128 threads a block;
// __launch_bounds__(128, 4): 128 registers a lane, 16 warps a
// multiprocessor. A freshly built library is held against the plain
// version on known answers before its first verdict
// (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field products a signature (b3 * x
// is a small-constant multiply and not counted): joint table 2 doublings x
// (6 + 2 squarings) + 11 mixed additions x 11 = 133 products and 4
// squarings; 63 Q steps x (2 doublings + 1 addition x 12) = 756 + 756
// products and 252 squarings; 16 mixed G additions x 11 = 176; accept 2.
// Total 1823 products of 64 + 8 32x32->64 multiplies and 256 squarings of
// 36 + 8 (triangular), each counted as 2 IMAD issue slots:
// 1823 x 144 + 256 x 88 = 285,040 IMAD a signature. The pair does work
// the bound does not count: a mixed addition's (x2 + y2)(X1 + Y1) runs on
// both lanes (11 table + 16 G additions): 1850 products and 256 squarings,
// 288,928 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1_pair.cuh"

// Wire layout (the JAX kernel's, unchanged):
//   g_idx   (16, n) i32: G-table index of outer step s (18 bits); row 0
//           carries rn_ok at bit 18
//   q_bits  (16, 4, n) u8: joint Q digits wc | wd << 2, MSB first
//   pts     (n, 4, 16) u16: Qc x, Qc y, Qd x, Qd y (affine, canonical)
//   r_limbs (n, 16) u16: r
//   tables  tab_x, tab_y (2^18, 16) u16 and tab_ok (2^18,) u8
static const int kBlock = 128;
static const int32_t kRowMask = (1 << 18) - 1;

__global__ void __launch_bounds__(kBlock, 4) secp256k1_hybrid_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_bits,
    const uint16_t *__restrict__ pts, const uint16_t *__restrict__ r_limbs,
    const uint16_t *__restrict__ tab_x, const uint16_t *__restrict__ tab_y,
    const uint8_t *__restrict__ tab_ok, uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint4 g_rows[kBlock / 2][4];
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4 *rows = g_rows[threadIdx.x >> 1];
  const int32_t g0 = g_idx[i];
  const bool rn_ok = (g0 >> 18) & 1;
  uint32_t flag =
      pair_fetch_row(rows, tab_x, tab_y, tab_ok, g0 & kRowMask, odd);

  k1fe qcx, qcy, qdx, qdy;
  const uint16_t *row = pts + i * 64;
  k1_load16(qcx, row);
  k1_load16(qcy, row + 16);
  k1_load16(qdx, row + 32);
  k1_load16(qdy, row + 48);
  // the joint table: T[2] = 2 T[1], T[3] = T[2] + Qc, T[8] = 2 T[4],
  // T[12] = T[8] + Qd and T[j + k] = T[j + k - 1] + Qc
  k1pt T[8], a, b;
  k1pt_identity(a);
  pair_row_put(T, 0, a, odd);
  a.X = qcx; a.Y = qcy; k1_one(a.Z);
  pair_row_put(T, 1, a, odd);
  k1pt_dbl_pair(a, a, odd);
  pair_row_put(T, 2, a, odd);
  k1pt_madd_pair(a, a, qcx, qcy, odd);
  pair_row_put(T, 3, a, odd);
  a.X = qdx; a.Y = qdy; k1_one(a.Z);
  pair_row_put(T, 4, a, odd);
#pragma unroll 1
  for (int k = 5; k < 8; ++k) {
    k1pt_madd_pair(a, a, qcx, qcy, odd);
    pair_row_put(T, k, a, odd);
  }
  a.X = qdx; a.Y = qdy; k1_one(a.Z);
  k1pt_dbl_pair(a, a, odd);
  pair_row_put(T, 8, a, odd);
  k1pt_madd_pair(b, a, qdx, qdy, odd);
  pair_row_put(T, 12, b, odd);
#pragma unroll 1
  for (int k = 9; k < 12; ++k) {
    k1pt_madd_pair(a, a, qcx, qcy, odd);
    pair_row_put(T, k, a, odd);
  }
#pragma unroll 1
  for (int k = 13; k < 16; ++k) {
    k1pt_madd_pair(b, b, qcx, qcy, odd);
    pair_row_put(T, k, b, odd);
  }

  // outer step s: 4 x (2 doublings + 1 Q add), then one G add; step 0
  // starts from the identity, so its first Q add is the entry itself
  k1pt acc;
  pair_row_get(acc, T, q_bits[i] & 15, odd);
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
      const int digit = q_bits[(s * 4 + k) * n + i] & 15;
      k1pt_dbl_pair(acc, acc, odd);
      k1pt_dbl_pair(acc, acc, odd);
      pair_row_get(a, T, digit, odd);
      k1pt_add_pair(acc, acc, a, odd);
    }
    cp_async_wait_all();
    __syncwarp();
    k1fe x2, y2;
    row_fe(x2, rows);
    row_fe(y2, rows + 2);
    k1pt_madd_pair(a, acc, x2, y2, odd);
    if (flag) acc = a;
    __syncwarp();
    if (s < 15)
      flag = pair_fetch_row(rows, tab_x, tab_y, tab_ok,
                            g_idx[(s + 1) * n + i] & kRowMask, odd);
  }

  // accept: Z != 0 and X == r*Z or, where r + n < p, X == (r + n)*Z
  k1fe r, rn, nn, rz, rnz;
  k1_load16(r, r_limbs + i * 16);
#pragma unroll
  for (int k = 0; k < 8; ++k) nn.v[k] = K1_N[k];
  k1_add(rn, r, nn);
  pair_mul<K1Field>(rz, rnz, r, acc.Z, rn, acc.Z, odd);
  const bool hit = k1_eq(acc.X, rz) || (rn_ok && k1_eq(acc.X, rnz));
  if (item < n && !odd) ok[i] = (!k1_is_zero(acc.Z) && hit) ? 1 : 0;
}

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers of contiguous tensors.
int secp256k1_hybrid_verify(const void *g_idx, const void *q_bits,
                            const void *pts, const void *r_limbs,
                            const void *tab_x, const void *tab_y,
                            const void *tab_ok, void *ok, int64_t n,
                            void *stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n * 2 + kBlock - 1) / kBlock;
  secp256k1_hybrid_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t *)g_idx, (const uint8_t *)q_bits, (const uint16_t *)pts,
      (const uint16_t *)r_limbs, (const uint16_t *)tab_x,
      (const uint16_t *)tab_y, (const uint8_t *)tab_ok, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor at ``block`` threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int secp256k1_hybrid_occupancy(int block) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, secp256k1_hybrid_verify_kernel, block, 0) == cudaSuccess
             ? blocks
             : -1;
}

int secp256k1_hybrid_block(void) { return kBlock; }

// Lanes (threads) a signature.
int secp256k1_hybrid_lanes(void) { return 2; }

const char *secp256k1_hybrid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
