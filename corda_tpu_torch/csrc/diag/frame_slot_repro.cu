// Reproducer of an nvcc miscompile (12.9, sm_90a; ROADMAP §C.1): Comba
// product loops whose bounds depend on the column stay rolled, so their
// operands live in local memory, and a kernel local that a __noinline__
// function writes through a reference gets the slot of the next product's
// operand, whose stores overwrite it before it is read. Not built by the
// package. On a card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o repro \
//       corda_tpu_torch/csrc/diag/frame_slot_repro.cu && ./repro
// exits 1 ("miscompiled"); -DUNROLLED (constant loop bounds, the repair in
// csrc/carry.cuh) exits 0; -DBY_VALUE alone still exits 1. B7 windowed's
// pair kernel cut down: the field (portable C++), lane pairs swapping
// products by shuffles, a ladder, the Fermat inversion, one pair product
// of a lane's pick and zi; the host checks zi Z = 1 (mod 2^255 - 19).
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

#define HD __host__ __device__
struct fe { uint32_t v[8]; };
struct pt { fe X, Y, Z, T; };

// a * b mod p = 2^255 - 19, a value below 2^256: Comba columns, fold by 38.
HD inline void fe_mul(fe &o, const fe &a, const fe &b) {
  uint32_t t[16], c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#ifdef UNROLLED
#pragma unroll
    for (int i = 0; i < 8; ++i) if (k - i >= 0 && k - i < 8) {
#else
#pragma unroll
    for (int i = (k < 8 ? 0 : k - 7); i <= (k < 8 ? k : 7); ++i) {
#endif
      const uint64_t p = (uint64_t)a.v[i] * b.v[k - i];
      const uint64_t s = (((uint64_t)c1 << 32) | c0) + p;
      c2 += s < p, c0 = (uint32_t)s, c1 = (uint32_t)(s >> 32);
    }
    t[k] = c0, c0 = c1, c1 = c2, c2 = 0;
  }
  t[15] = c0;
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i, c >>= 32) t[i] = (uint32_t)(c += t[i] + 38ull * t[i + 8]);
  c *= 38;
  for (int i = 0; i < 8; ++i, c >>= 32) o.v[i] = (uint32_t)(c += t[i]);
  o.v[0] += (uint32_t)c * 38u;
}

#ifdef BY_VALUE
HD __noinline__ fe fe_sqr_n(fe a, int n) {
  for (int i = 0; i < n; ++i) fe_mul(a, a, a);
  return a;
}
#define SQR_N(o, a, n) o = fe_sqr_n(a, n)
#else
HD __noinline__ void fe_sqr_n(fe &o, const fe &a, int n) {
  o = a;
  for (int i = 0; i < n; ++i) fe_mul(o, o, o);
}
#define SQR_N(o, a, n) fe_sqr_n(o, a, n)
#endif

// o = a^(p-2) by the curve25519 addition chain.
HD inline void inv_chain(fe &o, const fe &a) {
  fe z2, z9, z11, t, z5, z10, z20, z50, z100;
  fe_mul(z2, a, a);  SQR_N(t, z2, 2);     fe_mul(z9, t, a);
  fe_mul(z11, z9, z2);  fe_mul(t, z11, z11);  fe_mul(z5, t, z9);
  SQR_N(t, z5, 5);   fe_mul(z10, t, z5);  SQR_N(t, z10, 10);
  fe_mul(z20, t, z10);  SQR_N(t, z20, 20);  fe_mul(t, t, z20);
  SQR_N(t, t, 10);   fe_mul(z50, t, z10);  SQR_N(t, z50, 50);
  fe_mul(z100, t, z50);  SQR_N(t, z100, 100);  fe_mul(t, t, z100);
  SQR_N(t, t, 50);   fe_mul(t, t, z50);   SQR_N(t, t, 5);
  fe_mul(o, t, z11);
}

#ifdef BY_VALUE
HD __noinline__ fe fe_inv(fe a) { fe o; inv_chain(o, a); return o; }
#define INV(o, a) o = fe_inv(a)
#else
HD __noinline__ void fe_inv(fe &o, const fe &a) { inv_chain(o, a); }
#define INV(o, a) fe_inv(o, a)
#endif

// r0 = a0 b0 (the even lane's product) and r1 = a1 b1 (the odd lane's),
// on both lanes of the pair.
__device__ inline void pair_mul(fe &r0, fe &r1, const fe &a0, const fe &b0,
                                const fe &a1, const fe &b1, bool odd) {
  fe x, y, m;
  for (int i = 0; i < 8; ++i) x.v[i] = odd ? a1.v[i] : a0.v[i];
  for (int i = 0; i < 8; ++i) y.v[i] = odd ? b1.v[i] : b0.v[i];
  fe_mul(m, x, y);
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = __shfl_xor_sync(0xffffffffu, m.v[i], 1);
    r0.v[i] = odd ? w : m.v[i];
    r1.v[i] = odd ? m.v[i] : w;
  }
}

__global__ void kernel(const pt *in, fe *out) {
  const bool odd = threadIdx.x & 1;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  pt acc = in[i];
#pragma unroll 1
  for (int s = 0; s < 16; ++s) {
    fe a, b;
    pair_mul(a, b, acc.X, acc.Y, acc.Z, acc.T, odd);
    pair_mul(acc.Z, acc.T, a, b, acc.Z, b, odd);
    acc.X = a, acc.Y = b;
  }
  fe zi, x, y;  INV(zi, acc.Z);
  pair_mul(x, y, acc.X, zi, acc.Y, zi, odd);
  fe *o = out + 4 * (2 * i + odd);
  o[0] = acc.Z, o[1] = zi, o[2] = x, o[3] = y;
}

// r = 1 (mod p), r < 2^256: r less p at most twice, then 1.
bool is_one(fe r) {
  const uint32_t p[8] = {0xffffffedu, ~0u, ~0u, ~0u, ~0u, ~0u, ~0u, 0x7fffffffu};
  for (int pass = 0; pass < 2; ++pass) {
    fe d;  uint64_t b = 0;
    for (int k = 0; k < 8; ++k, b = b >> 63 & 1) d.v[k] = (uint32_t)(b = (uint64_t)r.v[k] - p[k] - b);
    if (!b) r = d;
  }
  uint32_t rest = r.v[0] ^ 1u;
  for (int k = 1; k < 8; ++k) rest |= r.v[k];
  return rest == 0;
}

int main() {
  const int n = 1024;
  static pt in[n];
  static fe out[8 * n];
  uint64_t s = 0x9e3779b97f4a7c15ull;
  for (int k = 0; k < 32 * n; ++k) {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    (&in[k / 32].X)[k / 8 % 4].v[k % 8] = (uint32_t)(s >> 33);
  }
  pt *d_in;  fe *d_out;
  cudaMalloc(&d_in, sizeof(in)), cudaMalloc(&d_out, sizeof(out));
  cudaMemcpy(d_in, in, sizeof(in), cudaMemcpyHostToDevice);
  kernel<<<2 * n / 128, 128>>>(d_in, d_out);
  if (cudaMemcpy(out, d_out, sizeof(out), cudaMemcpyDeviceToHost)) return 2;
  int bad = 0;
  for (int j = 0; j < 2 * n; ++j) {
    fe r;
    fe_mul(r, out[4 * j + 1], out[4 * j]), bad += !is_one(r);
  }
  printf("%s: %d of %d lanes hold a wrong inverse\n", bad ? "miscompiled" : "exact", bad, 2 * n);
  return bad ? 1 : 0;
}
