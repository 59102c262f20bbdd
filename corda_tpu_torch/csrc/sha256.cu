// Batched SHA-256 and Merkle levels on Hopper (kernel B6).
//
// Replaces the TPU kernels of corda_tpu/ops/sha256.py: compress (:56),
// _sha256_blocks_impl (:90), hash_pairs (:111) and the per-level body of
// _merkle_root_impl (:122). Words are the native uint32 values of the
// big-endian message words (the host helpers unpack them); the wrapper
// passes int32 views of the same bits.
//
// Design: one thread per message or pair. The eight state words and a
// rolling 16-word message schedule stay in registers for the whole
// compression; the rounds are fully unrolled, so every schedule index is a
// compile-time constant and nothing goes through local or device memory
// between rounds (the rolling window replaces the JAX scan carry at
// sha256.py:70-84). A Merkle pair compresses (IV, left || right) and then
// the constant pad block of a 64-byte message, whose schedule is fixed: its
// W[t] + K[t] are the PAD_WK constants below. merkle_root is one
// hash_pairs launch per level on shrinking buffers, issued by the wrapper
// on the current stream without a synchronise.
//
// Bound: 32-bit integer instruction issue. A round is 14 instructions with
// LOP3 (3-input logic), SHF (funnel-shift rotate) and IADD3 (3-input add):
// Sigma1 3 SHF + 1 LOP3, Ch 1 LOP3, Sigma0 3 SHF + 1 LOP3, Maj 1 LOP3,
// t1 2 IADD3, e 1 IADD, a 1 IADD3. A schedule word is 10: sigma0 and
// sigma1 3 SHF + 1 LOP3 each, 2 IADD3. A compression is 64 x 14 + 48 x 10
// + 8 (the feed-forward) = 1,384; the pad block's compression has no
// schedule work and its W + K are immediates: 64 x 14 + 8 = 904. So a pair
// is 2,288 instructions and a block of sha256_blocks 1,384. At 64 32-bit
// integer lanes a clock on each of the 132 SMs (16.75e12 instructions a
// second, chip_smoke.py's rate) 131,072 pairs need 17.9 us; they move 96
// bytes each (12.6 MB, 3.8 us at 3.35 TB/s), so B6 is operation-bound.
#include <cuda_runtime.h>
#include <stdint.h>

__constant__ uint32_t SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// W[t] + K[t] of the pad block of a 64-byte message (0x80000000, fourteen
// zero words, the bit length 512).
__constant__ uint32_t PAD_WK[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One round on the working variables s[0..7] = a..h with wk = W[t] + K[t].
__device__ __forceinline__ void sha_round(uint32_t s[8], uint32_t wk) {
  const uint32_t a = s[0], b = s[1], c = s[2], e = s[4], f = s[5], g = s[6];
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = s[7] + s1 + ch + wk;
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  s[7] = g;
  s[6] = f;
  s[5] = e;
  s[4] = s[3] + t1;
  s[3] = c;
  s[2] = b;
  s[1] = a;
  s[0] = t1 + s0 + maj;
}

// state += compression of the 16-word block w (w is overwritten: it is the
// rolling schedule window).
__device__ __forceinline__ void compress(uint32_t state[8], uint32_t w[16]) {
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = state[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint32_t sg0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t sg1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] = w[t & 15] + sg0 + w[(t + 9) & 15] + sg1;
    }
    sha_round(s, w[t & 15] + SHA_K[t]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] += s[i];
}

// state += compression of the constant pad block of a 64-byte message.
__device__ __forceinline__ void compress_pad64(uint32_t state[8]) {
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = state[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) sha_round(s, PAD_WK[t]);
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] += s[i];
}

__device__ __forceinline__ void set_iv(uint32_t st[8]) {
  st[0] = 0x6a09e667u;
  st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu;
  st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu;
  st[7] = 0x5be0cd19u;
}

__device__ __forceinline__ void load16(uint32_t w[16], const uint32_t *p) {
  const uint4 *q = reinterpret_cast<const uint4 *>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = __ldg(q + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store8(uint32_t *p, const uint32_t st[8]) {
  uint4 *q = reinterpret_cast<uint4 *>(p);
  q[0] = make_uint4(st[0], st[1], st[2], st[3]);
  q[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// pairs (n, 16) -> digests (n, 8): SHA-256 of each 64-byte left || right.
__global__ void hash_pairs_kernel(const uint32_t *__restrict__ pairs,
                                  uint32_t *__restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t w[16], st[8];
    load16(w, pairs + 16 * i);
    set_iv(st);
    compress(st, w);
    compress_pad64(st);
    store8(out + 8 * i, st);
  }
}

// blocks (n, n_blocks, 16) of padded messages -> digests (n, 8).
__global__ void sha256_blocks_kernel(const uint32_t *__restrict__ blocks,
                                     uint32_t *__restrict__ out, int64_t n,
                                     int64_t n_blocks) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t st[8];
    set_iv(st);
    const uint32_t *msg = blocks + 16 * n_blocks * i;
    for (int64_t b = 0; b < n_blocks; ++b) {
      uint32_t w[16];
      load16(w, msg + 16 * b);
      compress(st, w);
    }
    store8(out + 8 * i, st);
  }
}

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  // the grid-stride loops cover any n beyond this many blocks
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return (unsigned)blocks;
}

extern "C" {

// Each launches its kernel on ``stream`` and returns cudaGetLastError() (0
// on success). Pointers are device pointers of contiguous, 16-byte aligned
// tensors.
int sha256_hash_pairs(const void *pairs, void *out, int64_t n, void *stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  hash_pairs_kernel<<<grid_for(n, threads), threads, 0,
                      (cudaStream_t)stream>>>((const uint32_t *)pairs,
                                              (uint32_t *)out, n);
  return (int)cudaGetLastError();
}

int sha256_blocks(const void *blocks, void *out, int64_t n, int64_t n_blocks,
                  void *stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  sha256_blocks_kernel<<<grid_for(n, threads), threads, 0,
                         (cudaStream_t)stream>>>((const uint32_t *)blocks,
                                                 (uint32_t *)out, n, n_blocks);
  return (int)cudaGetLastError();
}

const char *sha256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
