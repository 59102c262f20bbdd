// secp256r1 half-gcd split batch ECDSA verification on Hopper (kernel B4).
//
// Replaces the TPU kernel corda_tpu/ops/weierstrass.py:verify_core_r1_split
// (with r1_split_ladder, _q_table_single, select_tree, _add_m3, _dbl_m3 and
// _madd_w). The host (native sm_r1_prep_hg) has turned u1, u2 into
// W2 = [t_lo]G + [t_hi]G' + [|v1|](+-Q) with every scalar below 2^128
// (G' = [2^128]G) and computed x_D = x([v2]R); per item the kernel
// computes W2 and accepts when Z != 0 and X == x_D * Z.
//
// Design (redesigned for Hopper): two lanes of a warp per signature
// (csrc/lanes.cuh). Points are projective (X:Y:Z) with the complete a = -3
// formulas of Renes-Costello-Batina 2016 (Algorithms 4, 5 and 6), so there
// are no data-dependent branches; the peeled first step may select T[0],
// the identity (0:1:0). Per outer step (8 of them): 4 x (4 doublings + 1 Q
// add from the 16-entry per-item table {0..15}Q in local memory, 1.5 KB a
// lane), then a mixed add from the G' table and one from the G table (two
// 2^16-row affine tables of 4.2 MB each, resident in L2); their identity
// rows (flag 0) keep the accumulator. Both lanes hold the accumulator;
// each layer of independent products in the formulas
// (csrc/curve_p256_pair.cuh) is split between them and exchanged with
// __shfl_xor_sync, so a doubling runs 7 products deep instead of 13 and an
// addition 7 instead of 14. The field is csrc/field_p256_comba.cuh: Comba
// products and the FIPS 186-4 fast reduction on PTX carry chains
// (csrc/carry.cuh), a 36-multiply squaring. The next step's G' and G rows
// are copied into shared memory with cp.async (the even lane the G' row,
// the odd lane the G row) while the 16 doublings run, so their L2 latency
// leaves the chain. 128 threads a block; __launch_bounds__(128, 4): 128
// registers a lane, 16 warps a multiprocessor. Lane pairs run every batch
// size: at 32768 signatures too they beat the earlier one-thread kernel
// (PERF.md §6). A freshly built library is held against the plain version
// on known answers before its first verdict (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field products a signature (b is a
// full-width constant, so b * x counts as a product): Q table 7 doublings x
// (10 + 3 squarings) + 7 mixed additions x 13 = 161 products and 21
// squarings; 31 Q steps x (4 doublings + 1 addition x 14) = 1240 + 434
// products and 372 squarings; 16 mixed G additions x 13 = 208; accept 1.
// Total 2044 products of 64 32x32->64 multiplies and 393 squarings of 36
// (the fast reduction only adds and subtracts words), each counted as 2
// IMAD issue slots: 2044 x 128 + 393 x 72 = 289,928 IMAD a signature. The
// pair does work the bound does not count: the doubling's last product
// (2YZ Y^2), the mixed add's b y3 and the accept product run on both
// lanes (124 + 7 doublings, 16 + 7 mixed additions, 1 accept: 155
// products), and the doubling's Z^2 is a product beside X Y (131
// squarings become products): 2330 products and 262 squarings, 317,104
// IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_p256_pair.cuh"

// Wire layout (the JAX kernel's, unchanged):
//   g_idx    (8, 2, n) i32: [s][0] t_hi window (G' table), [s][1] t_lo
//            window (G table), 16 bits each, MSB first
//   q_digits (8, 4, n) u8: 4-bit |v1| digits, MSB first
//   q_x, q_y (n, 16) u16: Q affine, y sign-adjusted on the host
//   xd       (n, 16) u16: x([v2]R)
//   tables   lo (G) and hi (G') triples: x, y (2^16, 16) u16, ok (2^16,) u8
static const int kBlock = 128;

// The step-s G row ``which`` of one item (0: G', 1: G; x, y: 4 x 16 bytes)
// copied into rows[which]; returns the row's flag.
__device__ __forceinline__ uint32_t r1_fetch_g(
    uint4 rows[2][4], const int32_t *g_idx, const uint16_t *lo_x,
    const uint16_t *lo_y, const uint8_t *lo_ok, const uint16_t *hi_x,
    const uint16_t *hi_y, const uint8_t *hi_ok, int s, int64_t n, int64_t i,
    bool which) {
  const int32_t row = g_idx[(s * 2 + which) * n + i] & 0xFFFF;
  const uint16_t *x = (which ? lo_x : hi_x) + (int64_t)row * 16;
  const uint16_t *y = (which ? lo_y : hi_y) + (int64_t)row * 16;
  cp_async16(&rows[which][0], x);
  cp_async16(&rows[which][1], x + 8);
  cp_async16(&rows[which][2], y);
  cp_async16(&rows[which][3], y + 8);
  return __ldg((which ? lo_ok : hi_ok) + row);
}

__global__ void __launch_bounds__(kBlock, 4) secp256r1_split_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_digits,
    const uint16_t *__restrict__ q_x, const uint16_t *__restrict__ q_y,
    const uint16_t *__restrict__ xd, const uint16_t *__restrict__ lo_x,
    const uint16_t *__restrict__ lo_y, const uint8_t *__restrict__ lo_ok,
    const uint16_t *__restrict__ hi_x, const uint16_t *__restrict__ hi_y,
    const uint8_t *__restrict__ hi_ok, uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint4 g_rows[kBlock / 2][2][4];
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4(*rows)[4] = g_rows[threadIdx.x >> 1];
  // the G' (hi) and G (lo) rows of the next step: the even lane fetches
  // the G' row and the odd lane the G row
  uint32_t f_hi = 0, f_lo = 0;
#define R1_FETCH(s)                                                        \
  do {                                                                     \
    if (!odd)                                                              \
      f_hi = r1_fetch_g(rows, g_idx, lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok, \
                        (s), n, i, false);                                 \
    if (odd)                                                               \
      f_lo = r1_fetch_g(rows, g_idx, lo_x, lo_y, lo_ok, hi_x, hi_y, hi_ok, \
                        (s), n, i, true);                                  \
  } while (0)
  R1_FETCH(0);

  p256fe qx, qy;
  p256_load16(qx, q_x + i * 16);
  p256_load16(qy, q_y + i * 16);
  r1pt T[16];
  r1pt_identity(T[0]);
  T[1].X = qx; T[1].Y = qy; p256_one(T[1].Z);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    if (k & 1)
      r1pt_madd_pair(T[k], T[k - 1], qx, qy, odd);
    else
      r1pt_dbl_pair(T[k], T[k >> 1], odd);
  }

  // outer step s: 4 x (4 doublings + 1 Q add), then the G' and G adds;
  // step 0 starts from the identity, so its first Q add is the entry itself
  r1pt acc = T[q_digits[i] & 15];
#pragma unroll 1
  for (int s = 0; s < 8; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) r1pt_dbl_pair(acc, acc, odd);
      r1pt_add_pair(acc, acc, T[q_digits[(s * 4 + k) * n + i] & 15], odd);
    }
    cp_async_wait_all();
    __syncwarp();
    const uint32_t other =
        __shfl_xor_sync(PAIR_FULL_MASK, odd ? f_lo : f_hi, 1);
    if (odd) f_hi = other; else f_lo = other;
    p256fe x2, y2;
    r1pt sum;
    row_fe(x2, rows[0]);
    row_fe(y2, rows[0] + 2);
    r1pt_madd_pair(sum, acc, x2, y2, odd);
    if (f_hi) acc = sum;
    row_fe(x2, rows[1]);
    row_fe(y2, rows[1] + 2);
    r1pt_madd_pair(sum, acc, x2, y2, odd);
    if (f_lo) acc = sum;
    __syncwarp();
    if (s < 7) R1_FETCH(s + 1);
  }
#undef R1_FETCH

  // accept: Z != 0 and X == x_D * Z
  p256fe d, dz;
  p256_load16(d, xd + i * 16);
  p256_mul(dz, d, acc.Z);
  if (item < n && !odd)
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
  const int64_t blocks = (n * 2 + kBlock - 1) / kBlock;
  secp256r1_split_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t *)g_idx, (const uint8_t *)q_digits, (const uint16_t *)q_x,
      (const uint16_t *)q_y, (const uint16_t *)xd, (const uint16_t *)lo_x,
      (const uint16_t *)lo_y, (const uint8_t *)lo_ok, (const uint16_t *)hi_x,
      (const uint16_t *)hi_y, (const uint8_t *)hi_ok, (uint8_t *)ok, n);
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor at ``block`` threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int secp256r1_split_occupancy(int block) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, secp256r1_split_verify_kernel, block, 0) == cudaSuccess
             ? blocks
             : -1;
}

int secp256r1_split_block(void) { return kBlock; }

// Lanes (threads) a signature.
int secp256r1_split_lanes(void) { return 2; }

const char *secp256r1_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
