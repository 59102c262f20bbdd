// Ed25519 batch verification by the windowed constant-B ladder on Hopper
// (kernel B7, windowed).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core_windowed
// (with windowed_ladder, _select4, madd_niels, add and double). Per item it
// computes [s]B + [k](-A) with w = 16 windows of s read from a 2^16-row
// Niels table of B and the digits of k, and accepts by RFC 8032
// re-encoding: after one Fermat inversion the canonical affine y must
// equal the wire y and x's parity the wire sign bit.
//
// Design (redesigned for Hopper): the wire is the JAX kernel's, with k in
// 2-bit digits; the kernel joins digits 2w and 2w + 1 into the base-16
// digit w of k (csrc/ed25519_windows.cuh a_window_digit). Each of the 16
// outer steps (16 bits of s and of k) is 4 windows of (4 doublings, one
// addition of the row [k_w](-A)), then one Niels mixed addition of B's row
// b_idx[step] (y + x, y - x, 2dxy; B2's low table, 6 MB, resident in the
// 50 MB L2). Window 0 starts from the identity, so it adds its row and
// doubles nothing: 252 doublings, 64 cached additions and 16 Niels
// additions, where the reference's 2-bit digits take 254 doublings and
// 127 additions of {O, -A, -2A, -3A}. The rows of {0..15}(-A) are per
// signature: 14 additions of -A from the identity, each row kept in cached
// form (Y - X, Y + X, Z, 2dT), so an addition of a row is 8 products and
// never multiplies by 2d (as B7 Shamir, csrc/ed25519_shamir.cu). Every
// formula is complete on edwards25519, so no kernel branches on the data.
// Two kernels, one launcher that takes the lanes a signature, which
// ed25519_windowed_lanes(n) picks by batch size (kPairItems), as B2 and B7
// Shamir do.
// - Lane pairs, up to kPairItems signatures: two lanes of a warp per
//   signature (csrc/lanes.cuh) on csrc/curve_ed25519_pair.cuh over the
//   Comba field csrc/field25519_comba.cuh. Each formula's layers of
//   independent products are split between the lanes: a doubling and a
//   cached addition run 4 products deep, a Niels addition 4 (T td on both
//   lanes), so a window is 20 deep. The -A table is split between the
//   lanes (rows 0-7 with the even lane, 8-15 with the odd one; 1 KB of
//   local memory a lane) and the owner of the selected row hands it over
//   by shuffles. The next step's B row is copied into shared memory with
//   cp.async (pair_fetch_row3, 96 bytes a pair) while the step's four
//   windows run, and the next window's digits are loaded while a window
//   runs. The inversion and the two affine products run on both lanes, as
//   in B2's pair kernel. Handing X zi and Y zi one to each lane after the
//   inversion (pair_mul, -DED25519_WINDOWED_PAIR_AFFINE) gave wrong
//   verdicts on the card while the Comba products kept their operands in
//   local memory and fe_inv wrote zi through a reference: nvcc gave zi the
//   frame slot of pair_mul's first operand, so each lane's zi became its
//   pick of X or Y (ROADMAP §C.1). With the products unrolled
//   (csrc/carry.cuh) and fe_inv returning by value both layouts are
//   exact; the lane-check builds
//   (-DED25519_WINDOWED_LANE_CHECK, chip_smoke.py's b7_lanes step,
//   tools/b7_lane_check.py) hold every item's lanes to the same point, zi,
//   affine x and y and verdict, and the first 64 items' zi and inversion
//   steps to Python's integers. One product a lane is the shorter chain;
//   this layout is kept until it is timed. Lanes past the ragged edge run
//   the last item again and store nothing. __launch_bounds__(128, 4): 128
//   registers a lane, 16 warps a multiprocessor.
// - One lane a signature, above kPairItems, where the card is full and the
//   work the pair repeats on both lanes costs more than its shorter chain
//   saves: the same schedule on csrc/curve_ed25519.cuh's field
//   (csrc/field25519.cuh; large one-thread kernels on the Comba field once
//   gave wrong verdicts, csrc/carry.cuh), the -A table whole in local
//   memory (2 KB). It computes T = E H in every doubling, though only a
//   window's last doubling feeds an addition: a variant that skipped it in
//   the other three (a T-less doubling, 189 products a signature) ran
//   0.5 ms slower at 32768 on an NVIDIA H100 80GB HBM3 at 700.00 W, in
//   turns.
// A freshly built library runs known answers through both kernels against
// the plain version before its first verdict (ops/known_answers.py).
//
// Bound: integer multiply throughput, counted on the least work known for
// the function: this schedule with T = E H computed only where an
// addition reads it (Hisil-Wong-Carter-Dawson 2008 s. 4.3; ref10's
// p1p1-to-p2 conversion), i.e. not in a doubling or addition that a
// doubling or the inversion follows: the -A table 15 cached forms x 1 +
// 14 cached additions x 8 = 127; 64 cached additions, 48 x 7 and the 16
// that a Niels addition follows x 8; 252 doublings x 4 squarings, 189 x 3
// products and the 63 that an addition follows x 4; 16 Niels additions x
// 6; the inversion 254 squarings + 11 products and two affine products:
// 1519 products and 1262 squarings. A product needs 64 + 8 wide
// 32x32->64 multiplies, a squaring 36 + 8, each counted as 2 IMAD issue
// slots: 1519 x 144 + 1262 x 88 = 329,792 IMAD a signature. The kernels
// compute every T (1772 products, 366,224 IMAD); the reference's 2-bit
// digits need 2297 products and 1274 squarings, 442,880. The one-lane
// kernel squares with a full product: 3034 x 144 = 436,896 IMAD. The pair
// repeats each Niels addition's T td (16), each cached form's T 2d (15),
// the inversion and the affine products on both lanes: 1816 products and
// 1516 squarings, 394,912 IMAD. Bytes per signature: 64 of windows, 128
// of digits, 128 of -A, 32 of R y, 1 of sign, 1 verdict, plus each
// distinct Niels row gathered (96 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_windows.cuh"

#ifdef ED25519_WINDOWED_LANE_CHECK
// Diagnostic build (tools/b7_lane_check.py, chip_smoke.py's b7_lanes): the
// pair kernel keeps, for its first kLaneWordItems items and on each lane,
// the ladder's X, Y, Z, zi and the canonical affine x and y (lane_words)
// and the value of every step of fe_inv's chain (inv_steps: the input,
// then steps 1-22), 8 words each.
namespace pairs {
static const int kLaneWordItems = 64;
static const int kLaneWordValues = 6;
static const int kInvSteps = 23;
__device__ uint32_t lane_words[kLaneWordItems][2][kLaneWordValues][8];
__device__ uint32_t inv_steps[kLaneWordItems][2][kInvSteps][8];

// Called by fe_inv (FE_INV_STEP) on every lane: thread t holds lane t & 1
// of item t >> 1.
__device__ __forceinline__ void inv_step_put(int k, const uint32_t *v) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 2 * kLaneWordItems) {
#pragma unroll
    for (int w = 0; w < 8; ++w) inv_steps[t >> 1][t & 1][k][w] = v[w];
  }
}
}  // namespace pairs
#define FE_INV_STEP(k, value) inv_step_put(k, (value).v)
#endif

namespace pairs {
#include "curve_ed25519_pair.cuh"
}  // namespace pairs

// Wire layout (the JAX kernel's, unchanged):
//   b_idx          (16, n) i32: w = 16 windows of s, MSB first
//   a_digits       (16, 8, n) u8: 2-bit digits of k, MSB first
//   ax, ay, az, at (n, 16) u16: -A in extended coordinates
//   r_y            (n, 16) u16: wire R y (canonical, host range-checked)
//   r_sign         (n,) u8: wire R sign bit
//   tp, tm, ttd    (65536, 16) u16: (y+x, y-x, 2dxy) of [j]B
static const int kBlock = 128;
// Batches of at most kPairItems signatures run on lane pairs, larger ones
// on one lane a signature.
static const int64_t kPairItems = 16384;

// -- one lane a signature: csrc/curve_ed25519.cuh's field and formulas ---

__global__ void __launch_bounds__(kBlock) ed25519_windowed_verify_kernel(
    const int32_t *__restrict__ b_idx, const uint8_t *__restrict__ a_digits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ r_y, const uint8_t *__restrict__ r_sign,
    const uint16_t *__restrict__ tp, const uint16_t *__restrict__ tm,
    const uint16_t *__restrict__ ttd, uint8_t *__restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // {0..15}(-A) in cached form: row k = row k - 1 + (-A)
  ge_cached T[16];
  ge p;
  fe_load16(p.X, ax + i * 16);
  fe_load16(p.Y, ay + i * 16);
  fe_load16(p.Z, az + i * 16);
  fe_load16(p.T, at + i * 16);
  ge_cached_identity(T[0]);
  ge_to_cached(T[1], p);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    ge_add_cached(p, p, T[1]);
    ge_to_cached(T[k], p);
  }

  // window w (0..63): 4 doublings (none in window 0, from the identity)
  // and the row [k_w](-A); after every fourth, B's row of the step
  int d = a_window_digit(a_digits, 0, n, i);
  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int d_next = w < 63 ? a_window_digit(a_digits, w + 1, n, i) : 0;
    if (w > 0) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) ge_double(acc, acc);
    }
    ge_add_cached(acc, acc, T[d]);
    if ((w & 3) == 3)
      ge_madd_niels(acc, tp, tm, ttd, b_idx[(int64_t)(w >> 2) * n + i]);
    d = d_next;
  }

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

// -- lane pairs: csrc/curve_ed25519_pair.cuh's field and formulas ---------

namespace pairs {

#ifdef ED25519_WINDOWED_LANE_CHECK
// Whether both lanes of the pair hold the same words of m.
__device__ __forceinline__ bool pair_same(const fe &m) {
  uint32_t d = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    d |= m.v[k] ^ __shfl_xor_sync(PAIR_FULL_MASK, m.v[k], 1);
  return d == 0;
}

__device__ __forceinline__ void lane_words_put(int64_t item, bool odd, int k,
                                               const fe &m) {
#pragma unroll
  for (int w = 0; w < 8; ++w) lane_words[item][odd][k][w] = m.v[w];
}
#endif

__global__ void __launch_bounds__(kBlock, 4) ed25519_windowed_verify_kernel(
    const int32_t *__restrict__ b_idx, const uint8_t *__restrict__ a_digits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ r_y, const uint8_t *__restrict__ r_sign,
    const uint16_t *__restrict__ tp, const uint16_t *__restrict__ tm,
    const uint16_t *__restrict__ ttd, uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint4 niels[kBlock / 2][6];
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4 *rows = niels[threadIdx.x >> 1];
  // step 0's B row, while the -A table is built
  pair_fetch_row3(rows, tp, tm, ttd, b_idx[i] & 0xFFFF, odd);

  // {0..15}(-A) in cached form, split between the lanes: row k = row
  // k - 1 + (-A)
  ge_cached T[8], a1, c;
  ge p;
  fe_load16(p.X, ax + i * 16);
  fe_load16(p.Y, ay + i * 16);
  fe_load16(p.Z, az + i * 16);
  fe_load16(p.T, at + i * 16);
  ge_cached_identity(c);
  pair_row_put(T, 0, c, odd);
  ge_to_cached(a1, p);
  pair_row_put(T, 1, a1, odd);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    ge_add_cached_pair(p, p, a1, odd);
    ge_to_cached(c, p);
    pair_row_put(T, k, c, odd);
  }

  // step s: 4 windows of (4 doublings, the row [k_w](-A)), none of them
  // doubling in window 0, then B's row b_idx[s], fetched a step ahead
  int d = a_window_digit(a_digits, 0, n, i);
  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const int w = 4 * s + j;
      const int d_next = w < 63 ? a_window_digit(a_digits, w + 1, n, i) : 0;
      if (w > 0) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) ge_double_pair(acc, acc, odd);
      }
      pair_row_get(c, T, d, odd);
      ge_add_cached_pair(acc, acc, c, odd);
      d = d_next;
    }
    cp_async_wait_all();
    __syncwarp();
    fe yp, ym, td;
    row_fe(yp, rows);
    row_fe(ym, rows + 2);
    row_fe(td, rows + 4);
    __syncwarp();
    if (s < 15)
      pair_fetch_row3(rows, tp, tm, ttd,
                      b_idx[(int64_t)(s + 1) * n + i] & 0xFFFF, odd);
    ge_madd_niels_pair(acc, yp, ym, td, odd);
  }

  // accept: one inversion and both affine products on both lanes (as B2's
  // pair kernel), then the canonical y against the wire's and x's parity
  // against its sign bit
  const fe zi = fe_inv(acc.Z);
  fe x, y, r;
#ifdef ED25519_WINDOWED_PAIR_AFFINE
  pair_mul<Field25519>(x, y, acc.X, zi, acc.Y, zi, odd);
#else
  fe_mul(x, acc.X, zi);
  fe_mul(y, acc.Y, zi);
#endif
  fe_canon(x, x);
  fe_canon(y, y);
  fe_load16(r, r_y + i * 16);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= y.v[k] ^ r.v[k];
  uint32_t v = diff == 0 && (x.v[0] & 1u) == (uint32_t)(r_sign[i] & 1);
#ifdef ED25519_WINDOWED_LANE_CHECK
  // diagnostic build (tools/b7_lane_check.py): bit 1 the odd lane's
  // verdict; bits 2-4 set where both lanes hold the same words of the
  // ladder's point, of zi and of the canonical affine x and y
  v |= __shfl_xor_sync(PAIR_FULL_MASK, v, 1) << 1;
  v |= (uint32_t)(pair_same(acc.X) & pair_same(acc.Y) & pair_same(acc.Z) &
                  pair_same(acc.T)) << 2;
  v |= (uint32_t)pair_same(zi) << 3;
  v |= (uint32_t)(pair_same(x) & pair_same(y)) << 4;
  if (item < kLaneWordItems) {
    lane_words_put(item, odd, 0, acc.X);
    lane_words_put(item, odd, 1, acc.Y);
    lane_words_put(item, odd, 2, acc.Z);
    lane_words_put(item, odd, 3, zi);
    lane_words_put(item, odd, 4, x);
    lane_words_put(item, odd, 5, y);
  }
#endif
  if (item < n && !odd) ok[i] = (uint8_t)v;
}

}  // namespace pairs

extern "C" {

// Lanes a signature for an n-item batch: 2 up to kPairItems, else 1.
int ed25519_windowed_lanes(int64_t n) { return n <= kPairItems ? 2 : 1; }

// Launches the ``lanes``-lane kernel (1 or 2; the wrapper passes
// ed25519_windowed_lanes(n)) on ``stream`` and returns cudaGetLastError()
// (0 on success). Pointers are device pointers of contiguous tensors.
int ed25519_windowed_verify(const void *b_idx, const void *a_digits,
                            const void *ax, const void *ay, const void *az,
                            const void *at, const void *r_y,
                            const void *r_sign, const void *tp,
                            const void *tm, const void *ttd, void *ok,
                            int64_t n, int lanes, void *stream) {
  if (lanes != 1 && lanes != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n * lanes + kBlock - 1) / kBlock;
#define WINDOWED_ARGS                                                       \
  (const int32_t *)b_idx, (const uint8_t *)a_digits, (const uint16_t *)ax, \
      (const uint16_t *)ay, (const uint16_t *)az, (const uint16_t *)at,    \
      (const uint16_t *)r_y, (const uint8_t *)r_sign,                      \
      (const uint16_t *)tp, (const uint16_t *)tm, (const uint16_t *)ttd,   \
      (uint8_t *)ok, n
  if (lanes == 2)
    pairs::ed25519_windowed_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                           (cudaStream_t)stream>>>(
        WINDOWED_ARGS);
  else
    ed25519_windowed_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                      (cudaStream_t)stream>>>(WINDOWED_ARGS);
#undef WINDOWED_ARGS
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the ``lanes``-lane kernel at
// ``block`` threads a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 on error.
int ed25519_windowed_occupancy(int block, int lanes) {
  int blocks = 0;
  cudaError_t rc = lanes == 2
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, pairs::ed25519_windowed_verify_kernel, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ed25519_windowed_verify_kernel, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int ed25519_windowed_block(void) { return kBlock; }

const char *ed25519_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef ED25519_WINDOWED_LANE_CHECK
// Copy the pair kernel's lane words and inversion steps of its last launch
// (u32 [kLaneWordItems][2 lanes][kLaneWordValues or kInvSteps][8]) to the
// host buffer dst; each returns the cudaError.
int ed25519_windowed_lane_words(void *dst) {
  return (int)cudaMemcpyFromSymbol(dst, pairs::lane_words,
                                   sizeof(pairs::lane_words));
}

int ed25519_windowed_inv_steps(void *dst) {
  return (int)cudaMemcpyFromSymbol(dst, pairs::inv_steps,
                                   sizeof(pairs::inv_steps));
}
#endif

}  // extern "C"
