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
// Design: one thread per signature, templated on the curve (K1Curve and
// P256Curve in csrc/curve_k1.cuh and csrc/curve_p256.cuh; one launcher
// picks the instantiation). The Q table is built with 7 doublings and 7
// mixed additions and lives in local memory (1.5 KB a thread). Per outer
// step (16 of them): 4 x (4 doublings + 1 complete addition of the
// selected T[digit]), then one mixed addition of the gathered G row. Step
// 0 is peeled: the accumulator starts at its first Q addend (which may be
// T[0], the identity (0:1:0)), so the ladder doubles 252 times. Row 0 of
// the G table is the identity with flag 0: the mixed addition is not valid
// for it, so a flag-0 row keeps the accumulator.
//
// Bound: integer multiply throughput. Field products a signature, counted
// as in csrc/secp256k1_hybrid.cu and csrc/secp256r1_split.cu:
// secp256k1 (doubling 6 + 2 squarings, addition 12, mixed addition 11):
// Q table 7 x 6 + 7 x 11 = 119 and 14 squarings; 252 doublings = 1512 and
// 504 squarings; 63 Q additions = 756; 16 G additions = 176; accept 2.
// Total 2565 products of 64 + 8 32x32->64 multiplies and 518 squarings of
// 36 + 8, each multiply 2 IMAD issue slots: 2565 x 144 + 518 x 88 =
// 414,944 IMAD a signature.
// secp256r1 (doubling 10 + 3 squarings, addition 14, mixed addition 13):
// Q table 161 and 21 squarings; 2520 and 756 squarings; 882; 208; accept
// 2. Total 3773 products of 64 and 777 squarings of 36:
// 3773 x 128 + 777 x 72 = 538,888 IMAD a signature.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1.cuh"
#include "curve_p256.cuh"

// Mixed-adds the affine row ``row`` of the G table into acc; flag-0 rows
// (the identity) leave acc as it was.
template <class C>
__device__ __forceinline__ void g_add(typename C::pt &acc,
                                      const uint16_t *tab_x,
                                      const uint16_t *tab_y,
                                      const uint8_t *tab_ok, int32_t row) {
  typename C::fe x2, y2;
  C::load16(x2, tab_x + (int64_t)row * 16);
  C::load16(y2, tab_y + (int64_t)row * 16);
  typename C::pt sum;
  C::madd(sum, acc, x2, y2);
  if (__ldg(tab_ok + row)) acc = sum;
}

// One thread per item. Wire layout (the JAX kernel's, unchanged):
//   g_idx    (16, n) i32: 16-bit windows of u1, MSB first
//   q_digits (16, 4, n) u8: 4-bit windows of u2, MSB first
//   q_x, q_y (n, 16) u16: Q affine
//   r_limbs  (n, 16) u16: r
//   rn_ok    (n,) u8: r + n < p
//   tables   tab_x, tab_y (2^16, 16) u16 and tab_ok (2^16,) u8
template <class C>
__global__ void __launch_bounds__(128) windowed_verify_kernel(
    const int32_t *__restrict__ g_idx, const uint8_t *__restrict__ q_digits,
    const uint16_t *__restrict__ q_x, const uint16_t *__restrict__ q_y,
    const uint16_t *__restrict__ r_limbs, const uint8_t *__restrict__ rn_ok,
    const uint16_t *__restrict__ tab_x, const uint16_t *__restrict__ tab_y,
    const uint8_t *__restrict__ tab_ok, uint8_t *__restrict__ ok,
    int64_t n) {
  typedef typename C::fe fe;
  typedef typename C::pt pt;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  fe qx, qy;
  C::load16(qx, q_x + i * 16);
  C::load16(qy, q_y + i * 16);
  pt T[16];
  C::identity(T[0]);
  T[1].X = qx;
  T[1].Y = qy;
  C::one(T[1].Z);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    if (k & 1)
      C::madd(T[k], T[k - 1], qx, qy);
    else
      C::dbl(T[k], T[k >> 1]);
  }

  // outer step s: 4 x (4 doublings + 1 Q add), then the G add; step 0
  // starts from the identity, so its first Q add is the entry itself
  pt acc = T[q_digits[i] & 15];
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
#pragma unroll 1
    for (int k = (s == 0) ? 1 : 0; k < 4; ++k) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) C::dbl(acc, acc);
      C::add(acc, acc, T[q_digits[(s * 4 + k) * n + i] & 15]);
    }
    g_add<C>(acc, tab_x, tab_y, tab_ok, g_idx[s * n + i] & 0xFFFF);
  }

  // accept: Z != 0 and X == r*Z or, where r + n < p, X == (r + n)*Z
  fe r, rn, nn, rz;
  C::load16(r, r_limbs + i * 16);
  C::order(nn);
  C::fadd(rn, r, nn);
  C::mul(rz, r, acc.Z);
  bool hit = C::eq(acc.X, rz);
  C::mul(rz, rn, acc.Z);
  hit = hit || (rn_ok[i] != 0 && C::eq(acc.X, rz));
  ok[i] = (!C::is_zero(acc.Z) && hit) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

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
  const int threads = kBlock;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define WINDOWED_ARGS                                                      \
  (const int32_t *)g_idx, (const uint8_t *)q_digits, (const uint16_t *)q_x, \
      (const uint16_t *)q_y, (const uint16_t *)r_limbs,                    \
      (const uint8_t *)rn_ok, (const uint16_t *)tab_x,                     \
      (const uint16_t *)tab_y, (const uint8_t *)tab_ok, (uint8_t *)ok, n
  if (curve == 0)
    windowed_verify_kernel<K1Curve><<<blocks, threads, 0, s>>>(WINDOWED_ARGS);
  else if (curve == 1)
    windowed_verify_kernel<P256Curve><<<blocks, threads, 0, s>>>(
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
            &blocks, windowed_verify_kernel<K1Curve>, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, windowed_verify_kernel<P256Curve>, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int weierstrass_windowed_block(void) { return kBlock; }

int weierstrass_windowed_lanes(void) { return kLanes; }

const char *weierstrass_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
