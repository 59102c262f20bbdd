// SIMM-style delta margin on Hopper (kernel B10).
//
// Replaces the TPU kernel corda_tpu/samples/simm_valuation.py:margin:
//   ws = rw * sum over trades of sens     (12,) risk-weighted net deltas
//   K  = sqrt(ws . C . ws)                correlated tenor aggregation
// over sens (n_trades, 12) float32, rw (12,) and C (12, 12) float32.
//
// Design: the kernel rounds every float32 operation in the order the
// reference's compiled program does (and margin_plain, its plain version),
// so the three give the same float32 margin. No atomics: the result is the
// same on every run.
//   pass 1 (repeated while more than 32 rows remain): the rows, padded with
//           zeros to a multiple of 32 (half the padding before them, the
//           rest after), are summed in windows of 32 consecutive rows, in
//           row order: m rows become ceil(m / 32). One thread a (window,
//           column).
//   pass 2: one block sums the <= 32 remaining rows in order, forms
//           ws = rw * colsum, v = ws . C with one fused multiply-add per
//           term (i ascending), the dot v . ws as eight one-term lanes
//           summed in lane order and then the last four terms fused on,
//           and the square root.
// Every rounding is explicit (__fadd_rn, __fmul_rn, __fmaf_rn, __fsqrt_rn),
// so nvcc's contraction of a * b + c into an FMA cannot change it.
//
// Bound: bytes. The function reads 48 bytes a trade (plus 624 of rw and C)
// and writes 4; its 12 additions a trade are far below the card's float32
// rate, so it is memory-bound: 48 MB for 2^20 trades is ~0.015 ms at
// 3.35 TB/s. Pass 1's later levels move 1/32 of the bytes of the one before.
#include <cuda_runtime.h>
#include <stdint.h>

#define SIMM_T 12
#define SIMM_WINDOW 32
#define SIMM_THREADS 256

// out[w][c] = sum over k < 32 of in[32 w - low + k][c], rows outside [0, m)
// being the zero padding (adding a zero leaves the sum as it is).
__global__ void __launch_bounds__(SIMM_THREADS) simm_window_kernel(
    const float *__restrict__ in, float *__restrict__ out, int64_t m,
    int low, int64_t m_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m_out * SIMM_T) return;
  const int64_t w = i / SIMM_T;
  const int c = (int)(i - w * SIMM_T);
  const int64_t r0 = w * SIMM_WINDOW - low;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < SIMM_WINDOW; ++k) {
    const int64_t r = r0 + k;
    if (r >= 0 && r < m) acc = __fadd_rn(acc, __ldg(in + r * SIMM_T + c));
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(32) simm_finish_kernel(
    const float *__restrict__ in, int m, const float *__restrict__ rw,
    const float *__restrict__ corr, float *__restrict__ out) {
  __shared__ float ws[SIMM_T];
  __shared__ float v[SIMM_T];
  const int t = threadIdx.x;
  if (t < SIMM_T) {
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s = __fadd_rn(s, in[k * SIMM_T + t]);
    ws[t] = __fmul_rn(rw[t], s);
  }
  __syncthreads();
  if (t < SIMM_T) {
    float a = 0.0f;
    for (int i = 0; i < SIMM_T; ++i)
      a = __fmaf_rn(ws[i], corr[i * SIMM_T + t], a);
    v[t] = a;
  }
  __syncthreads();
  if (t == 0) {
    float q = 0.0f;
    for (int l = 0; l < 8; ++l) q = __fadd_rn(q, __fmul_rn(v[l], ws[l]));
    for (int c = 8; c < SIMM_T; ++c) q = __fmaf_rn(v[c], ws[c], q);
    out[0] = __fsqrt_rn(q);
  }
}

extern "C" {

// Floats of scratch that simm_margin needs for n trades: pass 1's outputs.
int64_t simm_margin_scratch(int64_t n) {
  int64_t total = 0;
  for (int64_t m = n; m > SIMM_WINDOW; m = (m + SIMM_WINDOW - 1) / SIMM_WINDOW)
    total += (m + SIMM_WINDOW - 1) / SIMM_WINDOW * SIMM_T;
  return total;
}

// Both passes on ``stream``; ``scratch`` holds simm_margin_scratch(n)
// floats. Returns cudaGetLastError() (0 on success).
int simm_margin(const void *sens, const void *rw, const void *corr,
                void *scratch, void *out, int64_t n, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *in = (const float *)sens;
  float *next = (float *)scratch;
  int64_t m = n;
  while (m > SIMM_WINDOW) {
    const int64_t m_out = (m + SIMM_WINDOW - 1) / SIMM_WINDOW;
    const int low = (int)((m_out * SIMM_WINDOW - m) / 2);
    const int64_t threads = m_out * SIMM_T;
    simm_window_kernel<<<(unsigned)((threads + SIMM_THREADS - 1) /
                                    SIMM_THREADS),
                         SIMM_THREADS, 0, s>>>(in, next, m, low, m_out);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    in = next;
    next += threads;
    m = m_out;
  }
  simm_finish_kernel<<<1, 32, 0, s>>>(in, (int)m, (const float *)rw,
                                      (const float *)corr, (float *)out);
  return (int)cudaGetLastError();
}

const char *simm_margin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
