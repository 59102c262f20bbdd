// Ed25519 batch verification by the Shamir ladder on Hopper (kernel B7,
// Shamir).
//
// Replaces the TPU kernel corda_tpu/ops/ed25519.py:verify_core (with
// shamir_ladder, _select4, add and double). Per item it computes
// X = [s]B + [k](-A) over the MSB-first bit planes of s and k, and accepts
// by projective equality against the host-decoded affine R:
// X.X == Rx * X.Z and X.Y == Ry * X.Z, compared canonically.
//
// Design (redesigned for Hopper): Straus over 4-bit fixed windows of the
// same bit planes. Window w reads planes 4w..4w+3 of s and of k (the
// digits of s and k in base 16, most significant first); each of the 64
// windows is 4 doublings, one mixed addition of the Niels row [s_w]B and
// one addition of the row [k_w](-A). Window 0 starts from the identity, so
// it adds its two rows and doubles nothing: 252 doublings in all, against
// 256 doublings and 256 full additions for the bit ladder. The rows of
// {0..15}B are affine Niels (y + x, y - x, 2dxy), row 0 the identity
// (1, 1, 0), which the complete formula takes like any row; they are
// constants, copied once a block into shared memory (1.5 KB), where a
// warp's signatures read different rows without the serialisation of a
// divergent constant-cache read. The rows of {0..15}(-A) are per
// signature: 14 additions of -A from the identity, each row kept in cached
// form (Y - X, Y + X, Z, 2dT), so an addition of a row computes T1 2dT2
// and Z1 Z2 as two products and never multiplies by 2d. Every formula is
// complete on edwards25519, so no kernel branches on the data.
// Two kernels, one launcher that takes the lanes a signature, which
// ed25519_shamir_lanes(n) picks by batch size (kPairItems), as B2 does.
// - Lane pairs, up to kPairItems signatures: two lanes of a warp per
//   signature (csrc/lanes.cuh) on csrc/curve_ed25519_pair.cuh over the
//   Comba field csrc/field25519_comba.cuh. Each formula's layers of
//   independent products are split between the lanes: a doubling runs 4
//   products deep, a Niels addition 4 (T td on both lanes), a cached
//   addition 4, so a window is 24 deep. The -A table is split between the
//   lanes (rows 0-7 with the even lane, 8-15 with the odd one; 1 KB of
//   local memory a lane) and the owner of the selected row hands it over
//   by shuffles. The next window's digits are loaded while a window runs.
//   Lanes past the ragged edge run the last item again and store nothing.
//   __launch_bounds__(128, 4): 128 registers a lane, 16 warps a
//   multiprocessor.
// - One lane a signature, above kPairItems, where the card is full and the
//   work the pair repeats on both lanes (the additions, folds, selects and
//   shuffles) costs more than its shorter chain saves: the same schedule
//   on csrc/curve_ed25519.cuh's field (csrc/field25519.cuh; the Comba field
//   gave wrong verdicts in some builds of large one-thread kernels,
//   csrc/carry.cuh), the -A table whole in local memory (2 KB).
// A freshly built library runs known answers through both kernels against
// the plain version before its first verdict (ops/known_answers.py).
//
// Bound: integer multiply throughput, counted on the least work known for
// the function: this schedule with T = E H computed only where an
// addition reads it (Hisil-Wong-Carter-Dawson 2008 s. 4.3; ref10's
// p1p1-to-p2 conversion), i.e. not in a doubling or cached addition that
// a doubling or the acceptance follows: the -A table 15 cached forms x 1
// + 14 cached additions x 8 = 127; window 0 a Niels addition (7) and a
// cached addition (7); 63 windows x (3 doublings x (4 squarings + 3
// products) + 1 doubling x (4 + 4) + 7 + 7); acceptance 2: 1844 products
// and 1008 squarings. A product needs 64 + 8 wide 32x32->64 multiplies, a
// squaring 36 + 8, each counted as 2 IMAD issue slots: 1844 x 144 + 1008 x
// 88 = 354,240 IMAD a signature. The kernels compute every T (2097
// products, 390,672 IMAD); the reference's bit ladder (B - A 9; 256
// doublings x (4 squarings + 4 products); 256 additions x 9; acceptance 2)
// needs 3339 products and 1024 squarings, 570,928 IMAD. The one-lane
// kernel squares with a full product: 3105 x 144 = 447,120 IMAD. The pair
// repeats each Niels addition's T td (64) and each cached form's T 2d (15)
// on both lanes: 2176 products and 1008 squarings, 402,048 IMAD.
// Bytes per signature: 512 of bit planes, 128 of -A, 64 of R, 1 verdict.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_windows.cuh"

namespace pairs {
#include "curve_ed25519_pair.cuh"
}  // namespace pairs

// Wire layout (the JAX kernel's, unchanged):
//   s_bits, k_bits (256, n) u8: MSB-first bit planes of s and k
//   ax, ay, az, at (n, 16) u16: -A in extended coordinates
//   rx, ry         (n, 16) u16: R affine, canonical
static const int kBlock = 128;
// Batches of at most kPairItems signatures run on lane pairs, larger ones
// on one lane a signature.
static const int64_t kPairItems = 16384;

// {0..15}B as affine Niels rows (y + x, y - x, 2dxy), 24 little-endian
// words a row; row 0 is the identity (1, 1, 0).
__device__ __constant__ uint32_t ED_NIELS_B[16 * 24] = {
    // 0B
    0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    // 1B
    0xf58c3b85u, 0x2fbc93c6u, 0xfb8c0e19u, 0xcf932dc6u,
    0x643d42c2u, 0x270b4898u, 0x33d4ba65u, 0x07cf9d3au,
    0xd740913eu, 0x9d103905u, 0xd140beb3u, 0xfd399f05u,
    0x688f8a09u, 0xa5c18434u, 0x98f81267u, 0x44fd2f92u,
    0x877aaa68u, 0xabc91205u, 0xccaac49eu, 0x26d9e823u,
    0xdd43598cu, 0x5a1b7dcbu, 0x9f0c65a8u, 0x6f117b68u,
    // 2B
    0x933c71d7u, 0x9224e7fcu, 0x7a0ff5b5u, 0x9f469d96u,
    0xe1d60702u, 0x5aa69a65u, 0xa87d2e2eu, 0x590c063fu,
    0x42b4d5a8u, 0x8a99a560u, 0x4e60acf6u, 0x8f2b810cu,
    0xb16e37aau, 0xe09e236bu, 0x69c92555u, 0x6bb595a6u,
    0xa59b7a5fu, 0x43faa8b3u, 0x5d9acf78u, 0x36c16bddu,
    0x0b3d6a31u, 0x500fa084u, 0x3ea50b73u, 0x701af5b1u,
    // 3B
    0x4cee9730u, 0xaf25b0a8u, 0xe8864b8au, 0x025a8430u,
    0x9f016732u, 0xc11b5002u, 0x9a80f8f4u, 0x7a164e1bu,
    0xa4fcd265u, 0x56611fe8u, 0xe5c1ba7du, 0x3bd353fdu,
    0x214bd6bdu, 0x8131f31au, 0x555bda62u, 0x2ab91587u,
    0x0dd0d889u, 0x14ae933fu, 0x1c35da62u, 0x58942322u,
    0x8cf2db4cu, 0xd170e545u, 0x12b9b4c6u, 0x5a2826afu,
    // 4B
    0x8efc099fu, 0x287351b9u, 0x7dfd2538u, 0x6765c6f4u,
    0xfb0a9265u, 0xca348d3du, 0x21e58727u, 0x680e9103u,
    0x056818bfu, 0x95fe050au, 0x5660faa9u, 0x327e8971u,
    0x06a05073u, 0xc3e8e3cdu, 0x7445a49au, 0x27933f4cu,
    0xc476ff09u, 0x5a13fbe9u, 0x7b5cc172u, 0x6e9e3945u,
    0x102b4494u, 0x5ddbdcf9u, 0x63553e2bu, 0x7f9d0cbfu,
    // 5B
    0x08a5bb33u, 0xa212bc44u, 0xc75eed02u, 0x8d5048c3u,
    0x5abfec44u, 0xdd1beb0cu, 0x46e206ebu, 0x2945ccf1u,
    0xa447d6bau, 0x7f9182c3u, 0x4b2729b7u, 0xd50014d1u,
    0xb864a087u, 0xe33cf11cu, 0xeb1b55f3u, 0x154a7e73u,
    0x812a8285u, 0xbcbbdbf1u, 0xd0bdd1fcu, 0x270e0807u,
    0x1bbda72du, 0xb41b670bu, 0x6b3bb69au, 0x43aabe69u,
    // 6B
    0x77157131u, 0x3a0ceeebu, 0x00c8af88u, 0x9b271589u,
    0xda59a736u, 0x8065b668u, 0xa2cc38bdu, 0x51e57bb6u,
    0x7b7d8ca4u, 0x499806b6u, 0x27d22739u, 0x575be284u,
    0x204553b9u, 0xbb085ce7u, 0xae417884u, 0x38b64c41u,
    0x02ea4b71u, 0x85ac3267u, 0x41a1bb01u, 0xbe70e003u,
    0x083bc144u, 0x53e4a24bu, 0x9f0d61e3u, 0x10b8e91au,
    // 7B
    0x944ea3bfu, 0x6b1a5cd0u, 0xb39dc0d2u, 0x7470353au,
    0x28542e49u, 0x71b25282u, 0x283c927eu, 0x461bea69u,
    0xaa3221b1u, 0xba6f2c9au, 0x3bba23a7u, 0x6ca02153u,
    0x92192c3au, 0x9dea764fu, 0x2e5317e0u, 0x1d6edd5du,
    0x01b8b3a2u, 0xf1836dc8u, 0x053ea49au, 0xb3035f47u,
    0x5877adf3u, 0x529c41bau, 0x6a0f90a7u, 0x7a9fbb1cu,
    // 8B
    0x04dd3e8fu, 0x59b75966u, 0xe288702cu, 0x6cb30377u,
    0x5ed9c323u, 0xb1339c66u, 0x61bce52fu, 0x0915e760u,
    0xf39234d9u, 0xe2a75dedu, 0xe1b558f9u, 0x963d7680u,
    0x6e3c23fbu, 0x2c2741acu, 0x320e01c3u, 0x3a9024a1u,
    0xc9a2911au, 0xe7c1f5d9u, 0x8bcca7d7u, 0xb8a37178u,
    0x0eb62a32u, 0x63641219u, 0x2ecc4e95u, 0x26907c5cu,
    // 9B
    0xa6a8632fu, 0x9b2e678au, 0x51bc46c5u, 0xa6509e6fu,
    0xc686f5b5u, 0xceb233c9u, 0x8add7f59u, 0x34b9ed33u,
    0x039d8064u, 0xf36e217eu, 0xf520419bu, 0x98a081b6u,
    0xe75eb044u, 0x96cbc608u, 0xfadc9c8fu, 0x49c05a51u,
    0x9045af1bu, 0x06b4e8bfu, 0xa719d22fu, 0xe2ff83e8u,
    0x93d4cf16u, 0xaaf6fc29u, 0x1b008b06u, 0x73c17202u,
    // 10B
    0xb360748eu, 0xff1d93d2u, 0x1617e057u, 0x45f534d4u,
    0x9b554646u, 0x0d550363u, 0xaae591edu, 0x43ac7628u,
    0x227081ddu, 0x75f3558eu, 0x65a9f02fu, 0x04f81836u,
    0xf5dc3958u, 0x84739745u, 0x4950b702u, 0x0353832cu,
    0x03d0f8d8u, 0xd03d2ae4u, 0xd3f06340u, 0x1d0c1ccbu,
    0x6731b509u, 0xff169f0fu, 0x70bf4ce7u, 0x0ec62af4u,
    // 11B
    0x8a802adeu, 0x2fbf0084u, 0x02302e27u, 0xe5d9fecfu,
    0x17703406u, 0x113e8471u, 0x546d8fafu, 0x4275aae2u,
    0x49864348u, 0x315f5b02u, 0x77088381u, 0x3ed6b369u,
    0x6a8deb95u, 0xa3a07555u, 0x29d5c77fu, 0x18ab5980u,
    0xfd6089e9u, 0xd82b2cc5u, 0x3282e4a4u, 0x031eb4a1u,
    0xb51a8622u, 0x44311199u, 0xb53df948u, 0x3dc65522u,
    // 12B
    0xa71e7539u, 0xe2358042u, 0xd834d1a9u, 0x88de3dd7u,
    0x701a6f93u, 0x45ecdd2eu, 0x8d3cdd58u, 0x078aafdeu,
    0xb53d54b9u, 0x856f8375u, 0xccb25b24u, 0x23b2bf90u,
    0x56d5dbddu, 0x884dfb6eu, 0x8a6022edu, 0x7956ece2u,
    0x7f944553u, 0xeea594d8u, 0xa24e180bu, 0xf66cda23u,
    0xf4976461u, 0xffcb589au, 0x1c83d0c6u, 0x37c6a515u,
    // 13B
    0xa2007f6du, 0xbf70c222u, 0xb5bcdedbu, 0xbf84b39au,
    0xfb07ba07u, 0x537a0e12u, 0xc346f241u, 0x234fd7eeu,
    0x327fbf93u, 0x506f013bu, 0x9b776f6bu, 0xaefcebc9u,
    0xaaad5968u, 0x9d12b232u, 0x176024a7u, 0x0267882du,
    0x732ea378u, 0x5360a119u, 0xdf8dd471u, 0x2437e6b1u,
    0x91a7e533u, 0xa2ef37f8u, 0xaa097863u, 0x497ba6fdu,
    // 14B
    0x3f213df2u, 0x26f870ecu, 0x57efa987u, 0x80277fc0u,
    0x2881bdd5u, 0x1a474c04u, 0x464d1630u, 0x6eaf60b2u,
    0xd4171280u, 0xdfdb8a44u, 0xdb7ca331u, 0xce69b20fu,
    0x6eec47a9u, 0x112e56f1u, 0x5b3c80d2u, 0x2df0ea2cu,
    0x7a1e1b82u, 0x96a1c587u, 0xa2a9bf54u, 0xf02397edu,
    0x3ecb1baau, 0x9c1fdf70u, 0xd8ba9c93u, 0x24bf7e3cu,
    // 15B
    0x13cfeaa0u, 0x24cecc03u, 0x189c246du, 0x8648c28du,
    0xc1f2d4d0u, 0x2dbdbdfau, 0xf12de72bu, 0x61e22917u,
    0x468ccf0bu, 0x040bcd86u, 0x2a9910d6u, 0xd3829ba4u,
    0x07b25192u, 0x75083008u, 0x18d05ebfu, 0x43b5cd42u,
    0x9bd0b516u, 0x5d9a762fu, 0x373fdeeeu, 0xeb38af4eu,
    0x93d64270u, 0x032e5a7du, 0x0ae4d842u, 0x511d6121u};

// Copies the B rows into shared memory; every thread of the block calls it
// before any thread reads a row.
__device__ __forceinline__ void load_b_rows(uint32_t *rows) {
  for (int k = threadIdx.x; k < 16 * 24; k += blockDim.x)
    rows[k] = ED_NIELS_B[k];
  __syncthreads();
}

// The base-16 digit of window w (0..63, most significant first) from four
// MSB-first bit planes.
__device__ __forceinline__ int window_digit(const uint8_t *bits, int w,
                                            int64_t n, int64_t i) {
  const uint8_t *p = bits + (int64_t)(4 * w) * n + i;
  return ((p[0] & 1) << 3) | ((p[n] & 1) << 2) | ((p[2 * n] & 1) << 1) |
         (p[3 * n] & 1);
}

__global__ void __launch_bounds__(kBlock) ed25519_shamir_verify_kernel(
    const uint8_t *__restrict__ s_bits, const uint8_t *__restrict__ k_bits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ rx, const uint16_t *__restrict__ ry,
    uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint32_t b_rows[16 * 24];
  load_b_rows(b_rows);
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

  // window 0 from the identity: its two rows, no doublings
  int sd = window_digit(s_bits, 0, n, i), kd = window_digit(k_bits, 0, n, i);
  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int s_next = w < 63 ? window_digit(s_bits, w + 1, n, i) : 0;
    const int k_next = w < 63 ? window_digit(k_bits, w + 1, n, i) : 0;
    if (w > 0) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) ge_double(acc, acc);
    }
    fe yp, ym, td;
    load_b_row(yp, ym, td, b_rows, sd);
    ge_madd_row(acc, yp, ym, td);
    ge_add_cached(acc, acc, T[kd]);
    sd = s_next;
    kd = k_next;
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

// -- lane pairs: csrc/curve_ed25519_pair.cuh's field and formulas ---------

namespace pairs {

__global__ void __launch_bounds__(kBlock, 4) ed25519_shamir_verify_kernel(
    const uint8_t *__restrict__ s_bits, const uint8_t *__restrict__ k_bits,
    const uint16_t *__restrict__ ax, const uint16_t *__restrict__ ay,
    const uint16_t *__restrict__ az, const uint16_t *__restrict__ at,
    const uint16_t *__restrict__ rx, const uint16_t *__restrict__ ry,
    uint8_t *__restrict__ ok, int64_t n) {
  __shared__ uint32_t b_rows[16 * 24];
  load_b_rows(b_rows);
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;

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

  // window 0 from the identity: its two rows, no doublings
  int sd = window_digit(s_bits, 0, n, i), kd = window_digit(k_bits, 0, n, i);
  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int s_next = w < 63 ? window_digit(s_bits, w + 1, n, i) : 0;
    const int k_next = w < 63 ? window_digit(k_bits, w + 1, n, i) : 0;
    if (w > 0) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) ge_double_pair(acc, acc, odd);
    }
    fe yp, ym, td;
    load_b_row(yp, ym, td, b_rows, sd);
    ge_madd_niels_pair(acc, yp, ym, td, odd);
    pair_row_get(c, T, kd, odd);
    ge_add_cached_pair(acc, acc, c, odd);
    sd = s_next;
    kd = k_next;
  }

  // accept: Rx Z | Ry Z, compared canonically on both lanes
  fe r_x, r_y, tx, ty;
  fe_load16(r_x, rx + i * 16);
  fe_load16(r_y, ry + i * 16);
  pair_mul<Field25519>(tx, ty, r_x, acc.Z, r_y, acc.Z, odd);
  const bool hit = fe_equal_canon(acc.X, tx) && fe_equal_canon(acc.Y, ty);
  if (item < n && !odd) ok[i] = hit ? 1 : 0;
}

}  // namespace pairs

extern "C" {

// Lanes a signature for an n-item batch: 2 up to kPairItems, else 1.
int ed25519_shamir_lanes(int64_t n) { return n <= kPairItems ? 2 : 1; }

// Launches the ``lanes``-lane kernel (1 or 2; the wrapper passes
// ed25519_shamir_lanes(n)) on ``stream`` and returns cudaGetLastError() (0
// on success). Pointers are device pointers of contiguous tensors.
int ed25519_shamir_verify(const void *s_bits, const void *k_bits,
                          const void *ax, const void *ay, const void *az,
                          const void *at, const void *rx, const void *ry,
                          void *ok, int64_t n, int lanes, void *stream) {
  if (lanes != 1 && lanes != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n * lanes + kBlock - 1) / kBlock;
#define SHAMIR_ARGS                                                       \
  (const uint8_t *)s_bits, (const uint8_t *)k_bits, (const uint16_t *)ax, \
      (const uint16_t *)ay, (const uint16_t *)az, (const uint16_t *)at,   \
      (const uint16_t *)rx, (const uint16_t *)ry, (uint8_t *)ok, n
  if (lanes == 2)
    pairs::ed25519_shamir_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                         (cudaStream_t)stream>>>(
        SHAMIR_ARGS);
  else
    ed25519_shamir_verify_kernel<<<(unsigned)blocks, kBlock, 0,
                                    (cudaStream_t)stream>>>(SHAMIR_ARGS);
#undef SHAMIR_ARGS
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of the ``lanes``-lane kernel at
// ``block`` threads a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 on error.
int ed25519_shamir_occupancy(int block, int lanes) {
  int blocks = 0;
  cudaError_t rc = lanes == 2
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, pairs::ed25519_shamir_verify_kernel, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ed25519_shamir_verify_kernel, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int ed25519_shamir_block(void) { return kBlock; }

const char *ed25519_shamir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
