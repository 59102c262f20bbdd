// Batch ECDSA verification by the single-scalar windowed ladder on Hopper
// (kernel B5, secp256k1 and secp256r1, G windows of w = 16 bits).
//
// Replaces the TPU kernel
// corda_tpu/ops/weierstrass.py:verify_core_windowed_single (with
// windowed_ladder_single, _q_table_single, select_tree, add, dbl, _madd_w
// and _accept_rn). Per item it computes [u1]G + [u2]Q: u1 in sixteen 16-bit
// windows, each one gathered row of the curve's 2^16-row affine table
// {0..65535}G (4.2 MB with its flags, resident in the 50 MB L2), and u2 in
// 64 4-bit windows over the per-item table {0..15}Q. It accepts when
// Z != 0 and X == r*Z or, where r + n < p (rn_ok), X == (r + n)*Z; r + n is
// derived here from r.
//
// Design (redesigned for Hopper): one kernel template over two pair-curve
// traits (K1PairCurve in csrc/curve_k1_pair.cuh, P256PairCurve in
// csrc/curve_p256_pair.cuh; one launcher picks the instantiation), two
// lanes of a warp per signature (csrc/lanes.cuh) at every batch size, as
// B4 (csrc/secp256r1_split.cu) runs the same ladder with two G tables.
// Points are projective (X:Y:Z) with the complete formulas of
// Renes-Costello-Batina 2016, so no kernel branches on the data; T[0] is
// the identity (0:1:0), which the complete addition takes like any point.
// Both lanes hold the accumulator; each layer of independent products in
// a formula is split between them and exchanged with __shfl_xor_sync
// (secp256k1: a doubling 4 products deep instead of 8, an addition 6
// instead of 12; secp256r1: 7 instead of 13 and 14), over the Comba fields
// csrc/field_k1_comba.cuh and csrc/field_p256_comba.cuh (carry chains,
// 36-multiply squarings; the P-256 one replaces the earlier kernel's
// slower csrc/field_p256.cuh). The Q table is built with 7 doublings and 7
// mixed additions and split between the lanes as B3 splits its joint
// table: the even lane keeps rows 0-7 and the odd lane rows 8-15 in local
// memory (768 bytes a lane, the earlier one-thread kernel's 1.5 KB a
// signature), and the owner of the selected row hands it to its partner by
// shuffles. Per outer step (16 of them): 4 x (4 doublings + 1 addition of
// the selected T[digit]), then one mixed addition of the gathered G row.
// Step 0 is peeled: the accumulator starts at its first Q addend, so the
// ladder doubles 252 times. The next step's G row is copied into shared
// memory with cp.async (the even lane x, the odd lane y) while the step's
// 16 doublings run, so its L2 latency leaves the chain. Row 0 of the G
// table is the identity with flag 0: the mixed addition is not valid for
// it, so a flag-0 row keeps the accumulator. Lanes past the ragged edge
// run the last item again and store nothing. 128 threads a block;
// __launch_bounds__(128, 4): 128 registers a lane, 16 warps a
// multiprocessor. A freshly built library is held against the plain
// version on known answers for both curves before its first verdict
// (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field products a signature, counted
// as in csrc/secp256k1_hybrid.cu and csrc/secp256r1_split.cu:
// secp256k1 (doubling 6 + 2 squarings, addition 12, mixed addition 11):
// Q table 7 x 6 + 7 x 11 = 119 and 14 squarings; 252 doublings = 1512 and
// 504 squarings; 63 Q additions = 756; 16 G additions = 176; accept 2.
// Total 2565 products of 64 + 8 32x32->64 multiplies and 518 squarings of
// 36 + 8, each multiply 2 IMAD issue slots: 2565 x 144 + 518 x 88 =
// 414,944 IMAD a signature. The pair runs a mixed addition's
// (x2 + y2)(X1 + Y1) on both lanes (23 of them): 2588 products and 518
// squarings, 418,256 IMAD.
// secp256r1 (doubling 10 + 3 squarings, addition 14, mixed addition 13):
// Q table 161 and 21 squarings; 2520 and 756 squarings; 882; 208; accept
// 2. Total 3773 products of 64 and 777 squarings of 36:
// 3773 x 128 + 777 x 72 = 538,888 IMAD a signature. The pair doubling's
// Z^2 is a product beside X Y and its last product (2YZ Y^2) runs on both
// lanes (259 doublings), as does a mixed addition's b y3 (23): 4314
// products and 518 squarings, 589,488 IMAD.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1_pair.cuh"
#include "curve_p256_pair.cuh"

// Wire layout (the JAX kernel's, unchanged):
//   g_idx    (16, n) i32: 16-bit windows of u1, MSB first
//   q_digits (16, 4, n) u8: 4-bit windows of u2, MSB first
//   q_x, q_y (n, 16) u16: Q affine
//   r_limbs  (n, 16) u16: r
//   rn_ok    (n,) u8: r + n < p
//   tables   tab_x, tab_y (2^16, 16) u16 and tab_ok (2^16,) u8
static const int kBlock = 128;

template <class C>
__global__ void __launch_bounds__(kBlock, 4) windowed_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_digits,
    const uint16_t *__restrict__ q_x, const uint16_t *__restrict__ q_y,
    const uint16_t *__restrict__ r_limbs, const uint8_t *__restrict__ rn_ok,
    const uint16_t *__restrict__ tab_x, const uint16_t *__restrict__ tab_y,
    const uint8_t *__restrict__ tab_ok, uint8_t *__restrict__ ok,
    int64_t n) {
  typedef typename C::fe fe;
  typedef typename C::pt pt;
  __shared__ uint4 g_rows[kBlock / 2][4];
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4 *rows = g_rows[threadIdx.x >> 1];
  uint32_t flag =
      pair_fetch_row(rows, tab_x, tab_y, tab_ok, g_idx[i] & 0xFFFF, odd);

  // the Q table: T[k] = T[k - 1] + Q for odd k, 2 T[k / 2] for even k
  fe qx, qy;
  C::load16(qx, q_x + i * 16);
  C::load16(qy, q_y + i * 16);
  pt T[8], a;
  C::identity(a);
  pair_row_put(T, 0, a, odd);
  a.X = qx;
  a.Y = qy;
  C::one(a.Z);
  pair_row_put(T, 1, a, odd);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    if (k & 1) {
      C::madd(a, a, qx, qy, odd);
    } else {
      pair_row_get(a, T, k >> 1, odd);
      C::dbl(a, a, odd);
    }
    pair_row_put(T, k, a, odd);
  }

  // outer step s: 4 x (4 doublings + 1 Q add), then the G add; step 0
  // starts from the identity, so its first Q add is the entry itself
  pt acc;
  pair_row_get(acc, T, q_digits[i] & 15, odd);
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
      const int digit = q_digits[(s * 4 + k) * n + i] & 15;
#pragma unroll 1
      for (int d = 0; d < 4; ++d) C::dbl(acc, acc, odd);
      pair_row_get(a, T, digit, odd);
      C::add(acc, acc, a, odd);
    }
    cp_async_wait_all();
    __syncwarp();
    fe x2, y2;
    row_fe(x2, rows);
    row_fe(y2, rows + 2);
    C::madd(a, acc, x2, y2, odd);
    if (flag) acc = a;
    __syncwarp();
    if (s < 15)
      flag = pair_fetch_row(rows, tab_x, tab_y, tab_ok,
                            g_idx[(s + 1) * n + i] & 0xFFFF, odd);
  }

  // accept: Z != 0 and X == r*Z or, where r + n < p, X == (r + n)*Z
  fe r, rn, nn, rz, rnz;
  C::load16(r, r_limbs + i * 16);
  C::order(nn);
  C::fadd(rn, r, nn);
  pair_mul<typename C::field>(rz, rnz, r, acc.Z, rn, acc.Z, odd);
  const bool hit = C::eq(acc.X, rz) || (rn_ok[i] != 0 && C::eq(acc.X, rnz));
  if (item < n && !odd) ok[i] = (!C::is_zero(acc.Z) && hit) ? 1 : 0;
}

extern "C" {

// Launches the kernel of ``curve`` (0 secp256k1, 1 secp256r1) on
// ``stream`` and returns cudaGetLastError() (0 on success; an unknown
// curve is cudaErrorInvalidValue). Pointers are device pointers of
// contiguous tensors.
int weierstrass_windowed_verify(const void *g_idx, const void *q_digits,
                                const void *q_x, const void *q_y,
                                const void *r_limbs, const void *rn_ok,
                                const void *tab_x, const void *tab_y,
                                const void *tab_ok, void *ok, int64_t n,
                                int curve, void *stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n * 2 + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
#define WINDOWED_ARGS                                                      \
  (const int32_t *)g_idx, (const uint8_t *)q_digits, (const uint16_t *)q_x, \
      (const uint16_t *)q_y, (const uint16_t *)r_limbs,                    \
      (const uint8_t *)rn_ok, (const uint16_t *)tab_x,                     \
      (const uint16_t *)tab_y, (const uint8_t *)tab_ok, (uint8_t *)ok, n
  if (curve == 0)
    windowed_verify_kernel<K1PairCurve><<<blocks, kBlock, 0, s>>>(
        WINDOWED_ARGS);
  else if (curve == 1)
    windowed_verify_kernel<P256PairCurve><<<blocks, kBlock, 0, s>>>(
        WINDOWED_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef WINDOWED_ARGS
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of ``curve``'s kernel (0 secp256k1,
// 1 secp256r1) at ``block`` threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int weierstrass_windowed_occupancy(int block, int curve) {
  int blocks = 0;
  cudaError_t rc = curve == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, windowed_verify_kernel<K1PairCurve>, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, windowed_verify_kernel<P256PairCurve>, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int weierstrass_windowed_block(void) { return kBlock; }

// Lanes (threads) a signature.
int weierstrass_windowed_lanes(void) { return 2; }

const char *weierstrass_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
