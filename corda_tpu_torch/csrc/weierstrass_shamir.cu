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
// Design (redesigned for Hopper): one kernel template over two pair-curve
// traits (K1PairCurve, P256PairCurve; one launcher picks the
// instantiation), two lanes of a warp per signature (csrc/lanes.cuh) at
// every batch size: at 32768 signatures too they beat the earlier
// one-thread kernel for both curves (PERF.md §6). The pair formulas of
// csrc/curve_k1_pair.cuh (secp256k1: a doubling 4 products deep instead of
// 8, an addition 6 instead of 12) and csrc/curve_p256_pair.cuh
// (secp256r1: 7 instead of 13 and 14) run over the Comba fields
// csrc/field_k1_comba.cuh and csrc/field_p256_comba.cuh (carry chains,
// 36-multiply squarings; the P-256 one replaces the earlier kernel's
// slower csrc/field_p256.cuh). The addition is the complete RCB addition,
// because G + Q is the identity when Q = -G and a doubling when Q = G. An
// item the host rejected arrives as Q = G with u1 = u2 = 0: the
// accumulator stays the identity, Z = 0, and the accept refuses it before
// it compares. The four addends live in shared memory (4 x 96 bytes a
// pair, 24 KB a block); both lanes read the selected one at the same
// address, and the next step's two bits are loaded while the step runs.
// 128 threads a block; __launch_bounds__(128, 4): 128 registers a lane,
// 16 warps a multiprocessor. A freshly built library is held against the
// plain version on known answers for both curves before its first verdict
// (ops/known_answers.py).
//
// Bound: integer multiply throughput. Field products a signature, counted
// as in csrc/secp256k1_hybrid.cu and csrc/secp256r1_split.cu:
// secp256k1 (addition 12 products, doubling 6 + 2 squarings): G + Q 12,
// 256 x (6 + 12) = 4608, accept 2: 4622 products of 64 + 8 multiplies and
// 512 squarings of 36 + 8, each multiply 2 IMAD issue slots:
// 4622 x 144 + 512 x 88 = 710,624 IMAD a signature (the pairs do exactly
// this work).
// secp256r1 (b is full width, so b*x counts: addition 14, doubling 10 + 3
// squarings): G + Q 14, 256 x (10 + 14) = 6144, accept 2: 6160 products of
// 64 and 768 squarings of 36: 6160 x 128 + 768 x 72 = 843,776 IMAD. The
// pair doubling's Z^2 is a product beside X Y and its last product
// (2YZ Y^2) runs on both lanes: 6672 products and 512 squarings, 890,880
// IMAD.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve_k1_pair.cuh"
#include "curve_p256_pair.cuh"

// Wire layout (the JAX kernel's, with Q's three planes stacked):
//   u1_bits, u2_bits (256, n) u8: bit planes, MSB first
//   q_pts   (3, n, 16) u16: Q's projective X, Y, Z
//   r_cands (2, n, 16) u16: r, and r + n (or r)
static const int kBlock = 128;

// A point as 6 x 16 bytes of shared memory, and back.
template <class P>
__device__ __forceinline__ void pt_store(uint4 *d, const P &p) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint32_t *s = k < 2 ? p.X.v + 4 * k
                        : k < 4 ? p.Y.v + 4 * (k - 2) : p.Z.v + 4 * (k - 4);
    d[k] = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

template <class P>
__device__ __forceinline__ void pt_load(P &p, const uint4 *d) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    uint32_t *s = k < 2 ? p.X.v + 4 * k
                  : k < 4 ? p.Y.v + 4 * (k - 2) : p.Z.v + 4 * (k - 4);
    const uint4 q = d[k];
    s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
  }
}

template <class C>
__global__ void __launch_bounds__(kBlock, 4) shamir_verify_kernel(
    const uint8_t *__restrict__ u1_bits, const uint8_t *__restrict__ u2_bits,
    const uint16_t *__restrict__ q_pts, const uint16_t *__restrict__ r_cands,
    uint8_t *__restrict__ ok, int64_t n) {
  typedef typename C::fe fe;
  typedef typename C::pt pt;
  __shared__ uint4 addends[kBlock / 2][4][6];  // O, G, Q, G + Q
  const bool odd = threadIdx.x & 1;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  // lanes past the ragged edge run the last item again (every lane of the
  // warp must reach every exchange) and store nothing
  const int64_t i = item < n ? item : n - 1;
  uint4(*tab)[6] = addends[threadIdx.x >> 1];

  pt g, q, gq;
  C::generator(g);
  C::load16(q.X, q_pts + i * 16);
  C::load16(q.Y, q_pts + (n + i) * 16);
  C::load16(q.Z, q_pts + (2 * n + i) * 16);
  C::add(gq, g, q, odd);
  // the even lane stores O and G, the odd lane Q and G + Q
  if (odd) {
    pt_store(tab[2], q);
    pt_store(tab[3], gq);
  } else {
    pt o;
    C::identity(o);
    pt_store(tab[0], o);
    pt_store(tab[1], g);
  }
  __syncwarp();

  pt acc, a;
  C::identity(acc);
  int sel = (int)u1_bits[i] + 2 * (int)u2_bits[i];
#pragma unroll 1
  for (int t = 0; t < 256; ++t) {
    const int next = t < 255 ? (int)u1_bits[(t + 1) * n + i] +
                                   2 * (int)u2_bits[(t + 1) * n + i]
                             : 0;
    C::dbl(acc, acc, odd);
    pt_load(a, tab[sel & 3]);
    C::add(acc, acc, a, odd);
    sel = next;
  }

  // accept: Z != 0 and X == r*Z or X == r'*Z
  fe r0, r1, rz0, rz1;
  C::load16(r0, r_cands + i * 16);
  C::load16(r1, r_cands + (n + i) * 16);
  pair_mul<typename C::field>(rz0, rz1, r0, acc.Z, r1, acc.Z, odd);
  const bool hit = C::eq(acc.X, rz0) || C::eq(acc.X, rz1);
  if (item < n && !odd) ok[i] = (!C::is_zero(acc.Z) && hit) ? 1 : 0;
}

extern "C" {

// Launches the kernel of ``curve`` (0 secp256k1, 1 secp256r1) on
// ``stream`` and returns cudaGetLastError() (0 on success; an unknown
// curve is cudaErrorInvalidValue). Pointers are device pointers of
// contiguous tensors.
int weierstrass_shamir_verify(const void *u1_bits, const void *u2_bits,
                              const void *q_pts, const void *r_cands,
                              void *ok, int64_t n, int curve, void *stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n * 2 + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *b1 = (const uint8_t *)u1_bits;
  const uint8_t *b2 = (const uint8_t *)u2_bits;
  const uint16_t *q = (const uint16_t *)q_pts;
  const uint16_t *rc = (const uint16_t *)r_cands;
  if (curve == 0)
    shamir_verify_kernel<K1PairCurve><<<blocks, kBlock, 0, s>>>(
        b1, b2, q, rc, (uint8_t *)ok, n);
  else if (curve == 1)
    shamir_verify_kernel<P256PairCurve><<<blocks, kBlock, 0, s>>>(
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
            &blocks, shamir_verify_kernel<K1PairCurve>, block, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, shamir_verify_kernel<P256PairCurve>, block, 0);
  return rc == cudaSuccess ? blocks : -1;
}

int weierstrass_shamir_block(void) { return kBlock; }

// Lanes (threads) a signature.
int weierstrass_shamir_lanes(void) { return 2; }

const char *weierstrass_shamir_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
