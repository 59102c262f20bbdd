// Batch ECDSA verification by the Shamir ladder on Hopper (kernel B8,
// secp256k1 and secp256r1).
//
// Replaces the TPU kernel corda_tpu/ops/weierstrass.py:verify_core (with
// shamir_ladder, _select4, add, dbl and _accept). Per item it computes
// X = [u1]G + [u2]Q over the 256-bit MSB-first bit planes of u1 and u2:
// G + Q once, then 256 steps of one doubling and one complete addition of
// the selected {O, G, Q, G + Q}. It accepts when Z != 0 and X == r*Z or
// X == r'*Z for the two host candidates (r, and r + n where r + n < p,
// else r again).
//
// Design: one thread per signature, templated on the curve (K1Curve and
// P256Curve in csrc/curve_k1.cuh and csrc/curve_p256.cuh; one launcher
// picks the instantiation). The four addends live in local memory and
// the step's two bits pick one; the addition is the complete RCB
// addition, because G + Q is the identity when Q = -G and a doubling when
// Q = G. An item the host rejected arrives as Q = G with u1 = u2 = 0: the
// accumulator stays the identity, Z = 0, and the accept refuses it before
// it compares.
//
// Bound: integer multiply throughput. Field products a signature, counted
// as in csrc/secp256k1_hybrid.cu and csrc/secp256r1_split.cu:
// secp256k1 (addition 12 products, doubling 6 + 2 squarings): G + Q 12,
// 256 x (6 + 12) = 4608, accept 2: 4622 products of 64 + 8 multiplies and
// 512 squarings of 36 + 8, each multiply 2 IMAD issue slots:
// 4622 x 144 + 512 x 88 = 710,624 IMAD a signature.
// secp256r1 (b is full width, so b*x counts: addition 14, doubling 10 + 3
// squarings): G + Q 14, 256 x (10 + 14) = 6144, accept 2: 6160 products of
// 64 and 768 squarings of 36: 6160 x 128 + 768 x 72 = 843,776 IMAD.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1.cuh"
#include "curve_p256.cuh"

// One thread per item. Wire layout (the JAX kernel's, with Q's three
// planes stacked):
//   u1_bits, u2_bits (256, n) u8: bit planes, MSB first
//   q_pts   (3, n, 16) u16: Q's projective X, Y, Z
//   r_cands (2, n, 16) u16: r, and r + n (or r)
template <class C>
__global__ void __launch_bounds__(128) shamir_verify_kernel(
    const uint8_t *__restrict__ u1_bits, const uint8_t *__restrict__ u2_bits,
    const uint16_t *__restrict__ q_pts, const uint16_t *__restrict__ r_cands,
    uint8_t *__restrict__ ok, int64_t n) {
  typedef typename C::fe fe;
  typedef typename C::pt pt;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  pt T[4];  // O, G, Q, G + Q
  C::identity(T[0]);
  C::generator(T[1]);
  C::load16(T[2].X, q_pts + i * 16);
  C::load16(T[2].Y, q_pts + (n + i) * 16);
  C::load16(T[2].Z, q_pts + (2 * n + i) * 16);
  C::add(T[3], T[1], T[2]);

  pt acc;
  C::identity(acc);
#pragma unroll 1
  for (int t = 0; t < 256; ++t) {
    const int sel = (int)u1_bits[t * n + i] + 2 * (int)u2_bits[t * n + i];
    C::dbl(acc, acc);
    C::add(acc, acc, T[sel == 3 ? 3 : sel == 2 ? 2 : sel == 1 ? 1 : 0]);
  }

  // accept: Z != 0 and X == r*Z or X == r'*Z
  fe r, rz;
  C::load16(r, r_cands + i * 16);
  C::mul(rz, r, acc.Z);
  bool hit = C::eq(acc.X, rz);
  C::load16(r, r_cands + (n + i) * 16);
  C::mul(rz, r, acc.Z);
  hit = hit || C::eq(acc.X, rz);
  ok[i] = (!C::is_zero(acc.Z) && hit) ? 1 : 0;
}

// Launch geometry: threads a block, and threads (lanes) a signature.
static const int kBlock = 128, kLanes = 1;

extern "C" {

// Launches the kernel of ``curve`` (0 secp256k1, 1 secp256r1) on
// ``stream`` and returns cudaGetLastError() (0 on success; an unknown
// curve is cudaErrorInvalidValue). Pointers are device pointers of
// contiguous tensors.
int weierstrass_shamir_verify(const void *u1_bits, const void *u2_bits,
                              const void *q_pts, const void *r_cands,
                              void *ok, int64_t n, int curve, void *stream) {
  if (n <= 0) return 0;
  const int threads = kBlock;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *b1 = (const uint8_t *)u1_bits;
  const uint8_t *b2 = (const uint8_t *)u2_bits;
  const uint16_t *q = (const uint16_t *)q_pts;
  const uint16_t *rc = (const uint16_t *)r_cands;
  if (curve == 0)
    shamir_verify_kernel<K1Curve><<<blocks, threads, 0, s>>>(
        b1, b2, q, rc, (uint8_t *)ok, n);
  else if (curve == 1)
    shamir_verify_kernel<P256Curve><<<blocks, threads, 0, s>>>(
        b1, b2, q, rc, (uint8_t *)ok, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor of ``curve``'s kernel (0 secp256k1,
// 1 secp256r1) at ``block`` threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on error.
int weierstrass_shamir_occupancy(int block, int curve) {
  int blocks = 0;
  cudaError_t rc = curve == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, shamir_verify_kernel<K1Curve>, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, shamir_verify_kernel<P256Curve>, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int weierstrass_shamir_block(void) { return kBlock; }

int weierstrass_shamir_lanes(void) { return kLanes; }

const char *weierstrass_shamir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
