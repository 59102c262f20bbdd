// Ed25519 split-k batch verification on Hopper (kernel B2).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core_split (with
// split_ladder, _joint_a_table, madd_niels, add and double). Per item it
// computes [s_lo]B + [s_hi]B' + [k_lo](-A) + [k_hi](-A') over 128-bit
// scalar halves (B' = [2^128]B, A' = [2^128]A) and accepts by RFC 8032
// re-encoding: after one Fermat inversion the canonical affine y must equal
// the wire y and x's parity the wire sign bit.
//
// Design (redesigned for Hopper): two kernels, one launcher. The caller
// passes the lanes a signature; ed25519_split_lanes(n) is the choice by
// batch size (kPairItems). Formulas are the complete ones of the JAX
// kernel, so there are no data-dependent branches: every item runs the
// same ladder. The 16-entry joint table T[i + 4j] = [i](-A) + [j](-A')
// lives in local memory (2 KB a lane, cached in L1 and L2) because it is
// indexed by a per-item digit; the Niels rows of the two constant tables
// (6 x 2 MB) are resident in the 50 MB L2. 128 threads a block.
// - Lane pairs, up to kPairItems signatures, where the card has lanes to
//   spare and one signature's serial chain sets the time: two lanes of a
//   warp per signature (csrc/lanes.cuh). Both lanes hold the accumulator;
//   each layer of independent products in the formulas
//   (csrc/curve_ed25519_pair.cuh) is split between them and exchanged
//   with __shfl_xor_sync: an addition runs 5 products deep instead of 9, a
//   doubling 4 instead of 8, a Niels addition 4 instead of 7. The field is
//   csrc/field25519_comba.cuh: Comba products and the fold by 38 on PTX
//   carry chains (csrc/carry.cuh), a 36-multiply squaring. The next
//   window's Niels rows are copied into shared memory with cp.async (the
//   even lane the B row, the odd lane the B' row) while the eight a-steps
//   before them run. The final Fermat inversion runs on both lanes.
//   __launch_bounds__(128, 4): 128 registers a lane, 16 warps a
//   multiprocessor.
// - One lane a signature, above kPairItems, where the card is full and
//   issue slots set the time: the earlier one-thread kernel
//   (csrc/curve_ed25519.cuh, csrc/field25519.cuh, formulas called). There
//   the pair's repeated work (below) costs more than its shorter chain
//   saves (at 32768 signatures the pairs are slower, PERF.md §6). The
//   one-lane kernel keeps the earlier field: in large one-thread kernels the Comba field gave wrong verdicts on the card in some builds
//   (csrc/carry.cuh).
// A freshly built library runs known answers through both kernels against
// the plain version before its first verdict (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field multiplications or squarings per
// signature: joint table 2 doublings x 8 + 11 additions x 9 = 115; 63
// a-steps x (2 doublings x 8 + 1 addition x 9) = 1575 (the first of the 64
// a-steps starts from the identity and is a table select); 16 Niels mixed
// additions x 7 = 112; inversion 254 + 11 plus two affine products = 267.
// Total 2069, of which 766 are squarings (4 in each of the 128 doublings,
// 254 in the inversion) and 1303 products. A product needs 64 + 8 wide
// 32x32->64 multiplies (the 512-bit product and its fold), a squaring
// 36 + 8 (the triangular fe_sqr), each counted as 2
// IMAD issue slots: 1303 x 144 + 766 x 88 = 255,040 IMAD a signature. The
// one-lane kernel squares with a full product: 2069 x 144 = 297,936. The
// pair does work the bound does not count: each addition's T1 2d T2 step
// (11 table + 63 ladder additions), each Niels addition's T td (16), the
// inversion (11 products, 254 squarings) and the two affine products run
// on both lanes: 103 products and 254 squarings more, 1406 products and
// 1020 squarings in all, 292,224 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_ed25519.cuh"

namespace pairs {
#include "curve_ed25519_pair.cuh"
}  // namespace pairs

// Wire layout (the JAX kernel's, unchanged):
//   bb_idx   (16, n) i32: rows 0-7 B-table windows, rows 8-15 B'-table
//   a_packed (8, 8, n) u8: joint digits k_lo | k_hi << 2, MSB first
//   rows     (n, 6, 16) u16: -A (x, y, t), -A' (x, y, t), canonical limbs
//   r_packed (n, 16) u16: wire R y with its sign bit at limb 15 bit 15
//   tables   6 x (65536, 16) u16: (y+x, y-x, 2dxy) for B, then for B'
static const int kBlock = 128;
// Batches of at most kPairItems signatures run on lane pairs, where the
// card has lanes to spare and the shorter chain wins; larger ones on one
// lane a signature, where the card is full and the work the pair repeats
// on both lanes costs more than the chain saves.
static const int64_t kPairItems = 16384;

// -- one lane a signature: csrc/curve_ed25519.cuh's field and formulas ---

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

// -- lane pairs: csrc/curve_ed25519_pair.cuh's field and formulas ---------

namespace pairs {

// Window j's Niels row ``which`` of one item (0: the B table, 1: B'; y+x,
// y-x, 2dxy: 6 x 16 bytes) copied into rows[which].
__device__ __forceinline__ void ed_fetch_niels(
    uint4 rows[2][6], const int32_t *bb_idx, const uint16_t *tp,
    const uint16_t *tm, const uint16_t *ttd, const uint16_t *t2p,
    const uint16_t *t2m, const uint16_t *t2td, int j, int64_t n, int64_t i,
    bool which) {
  const int64_t off =
      (int64_t)(bb_idx[(which ? 8 + j : j) * n + i] & 0xFFFF) * 16;
  const uint16_t *src[3] = {(which ? t2p : tp) + off,
                            (which ? t2m : tm) + off,
                            (which ? t2td : ttd) + off};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cp_async16(&rows[which][2 * k], src[k]);
    cp_async16(&rows[which][2 * k + 1], src[k] + 8);
  }
}

__device__ __forceinline__ void ed_row_fe(fe &o, const uint4 *r) {
  o.v[0] = r[0].x; o.v[1] = r[0].y; o.v[2] = r[0].z; o.v[3] = r[0].w;
  o.v[4] = r[1].x; o.v[5] = r[1].y; o.v[6] = r[1].z; o.v[7] = r[1].w;
}

// Adds window j's B and B' Niels rows (fetched by ed_fetch_niels a window
// ahead into shared memory) into acc.
__device__ __forceinline__ void ed_add_niels(ge &acc, uint4 rows[2][6],
                                             bool odd) {
  cp_async_wait_all();
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    fe yp, ym, td;
    ed_row_fe(yp, rows[t]);
    ed_row_fe(ym, rows[t] + 2);
    ed_row_fe(td, rows[t] + 4);
    ge_madd_niels_pair(acc, yp, ym, td, odd);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kBlock, 4) ed25519_split_verify_kernel(
    const int32_t *__restrict__ bb_idx, const uint8_t *__restrict__ a_packed,
    const uint16_t *__restrict__ rows, const uint16_t *__restrict__ r_packed,
    const uint16_t *__restrict__ tp, const uint16_t *__restrict__ tm,
    const uint16_t *__restrict__ ttd, const uint16_t *__restrict__ t2p,
    const uint16_t *__restrict__ t2m, const uint16_t *__restrict__ t2td,
    uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint4 niels[kBlock / 2][2][6];
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4(*nrows)[6] = niels[threadIdx.x >> 1];
  // window j's rows: the even lane fetches the B row, the odd lane the B'
  ed_fetch_niels(nrows, bb_idx, tp, tm, ttd, t2p, t2m, t2td, 0, n, i, odd);

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
  ge_double_pair(T[2], T[1], odd);
  ge_add_pair(T[3], T[2], T[1], odd);
  ge_double_pair(T[8], T[4], odd);
  ge_add_pair(T[12], T[8], T[4], odd);
#pragma unroll 1
  for (int j = 4; j <= 12; j += 4) {
#pragma unroll 1
    for (int k = 1; k <= 3; ++k)
      ge_add_pair(T[j + k], T[j + k - 1], T[1], odd);
  }

  // a-step s (0..63) reads digit a_packed[s / 8][s % 8]; step 0 starts from
  // the identity, so it is the table entry itself.
  ge acc = T[a_packed[i] & 15];
#pragma unroll 1
  for (int s = 1; s < 64; ++s) {
    if ((s & 7) == 0) {
      ed_add_niels(acc, nrows, odd);
      ed_fetch_niels(nrows, bb_idx, tp, tm, ttd, t2p, t2m, t2td, s >> 3, n,
                     i, odd);
    }
    ge_double_pair(acc, acc, odd);
    ge_double_pair(acc, acc, odd);
    ge_add_pair(acc, acc, T[a_packed[s * n + i] & 15], odd);
  }
  ed_add_niels(acc, nrows, odd);

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
  if (item < n && !odd)
    ok[i] = (diff == 0 && (x.v[0] & 1u) == sign) ? 1 : 0;
}

}  // namespace pairs

extern "C" {

// Launches the ``lanes``-lane kernel (1 or 2) on ``stream`` and returns
// cudaGetLastError() (0 on success). Pointers are device pointers of
// contiguous tensors.
int ed25519_split_verify(const void *bb_idx, const void *a_packed,
                         const void *rows, const void *r_packed,
                         const void *tp, const void *tm, const void *ttd,
                         const void *t2p, const void *t2m, const void *t2td,
                         void *ok, int64_t n, int lanes, void *stream) {
  if (lanes != 1 && lanes != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n * lanes + kBlock - 1) / kBlock;
#define SPLIT_ARGS                                                          \
  (const int32_t *)bb_idx, (const uint8_t *)a_packed,                       \
      (const uint16_t *)rows, (const uint16_t *)r_packed,                   \
      (const uint16_t *)tp, (const uint16_t *)tm, (const uint16_t *)ttd,    \
      (const uint16_t *)t2p, (const uint16_t *)t2m, (const uint16_t *)t2td, \
      (uint8_t *)ok, n
  if (lanes == 2)
    pairs::ed25519_split_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                        (cudaStream_t)stream>>>(SPLIT_ARGS);
  else
    ed25519_split_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                   (cudaStream_t)stream>>>(SPLIT_ARGS);
#undef SPLIT_ARGS
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the ``lanes``-lane kernel at
// ``block`` threads a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 on error.
int ed25519_split_occupancy(int block, int lanes) {
  int blocks = 0;
  cudaError_t rc = lanes == 2
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, pairs::ed25519_split_verify_kernel, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ed25519_split_verify_kernel, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int ed25519_split_block(void) { return kBlock; }

// Lanes a signature for an n-item batch: 2 up to kPairItems, else 1.
int ed25519_split_lanes(int64_t n) { return n <= kPairItems ? 2 : 1; }

const char *ed25519_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
