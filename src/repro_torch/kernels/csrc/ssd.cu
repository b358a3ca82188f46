// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_kernel (Pallas;
// wrapper ssd_scan).  On the TPU the chunk axis was the sequential grid
// dimension and the state [N, P] sat in VMEM scratch between grid steps.
// Blocks of a CUDA grid run in no order, so here one block owns one
// (batch, head) pair and walks its chunks in a loop, carrying the state
// in shared memory as float32 (4 KB at N = 16, P = 64; 32 KB at N = 128).
//
// For each chunk of Q steps (Q = min(chunk, L), L % Q == 0):
//   stage x, dt, B, C into shared memory (float32);
//   cum  = inclusive prefix sum of dt * A;
//   G    = (C Bᵀ) ⊙ Γ,  Γ[i][j] = exp(cum_i - cum_j) where j <= i, else 0
//          (a select, as the Pallas kernel has it: above the diagonal the
//          exp may overflow, and inf * 0 would be NaN);
//   y    = G (dt x) + (C ⊙ exp(cum)) S + D x;
//   S    = exp(cum_Q) S + (B ⊙ exp(cum_Q - cum))ᵀ (dt x).
// After the last chunk S is written out: it is the state the prefill
// hands to decode (the reference obtains it by a second, sequential scan
// over all L steps).
//
// What bounds it on the H100: bytes, narrowly.  Per (batch, head) and
// chunk it does about Q (Q N + Q P + 4 N P) flops against 4 Q (2 P + 1)
// bytes of x, dt and y, plus B and C shared by all heads; at Hymba's
// prefill shape (Bt 4, L 1536, H 50, P 64, N 16) the whole call moves
// about 160 MB and does about 3 GFLOP.  This first version uses the
// CUDA cores only, one block per (batch, head), so a batch of 4 fills
// 200 blocks; its times are in PERF.md.  Explicit fmaf keeps the dot
// products fused although the port builds with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

// Shared memory (dynamic, float32):
//   x [Q][P], xdt [Q][P], B [Q][N+1], C [Q][N+1], G [Q][Q+1], S [N][P],
//   dt [Q], cum [Q], ecum [Q] = exp(cum), w [Q] = exp(total - cum).
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dv,
           float* __restrict__ y, float* __restrict__ state_out, int L,
           int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldq = Q + 1;
  float* x_s = smem;
  float* xdt_s = x_s + Q * P;
  float* b_s = xdt_s + Q * P;
  float* c_s = b_s + Q * ldn;
  float* g_s = c_s + Q * ldn;
  float* st_s = g_s + Q * ldq;
  float* dt_s = st_s + N * P;
  float* cum_s = dt_s + Q;
  float* ecum_s = cum_s + Q;
  float* w_s = ecum_s + Q;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float a = A[h];
  const float dskip = Dv[h];

  for (int idx = tid; idx < N * P; idx += kThreads) st_s[idx] = 0.f;

  const int n_chunks = L / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const long long t0 = static_cast<long long>(b) * L + c * Q;
    // ---- stage the chunk
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int t = idx / P, p = idx - t * P;
      x_s[idx] = x[((t0 + t) * H + h) * P + p];
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int t = idx / N, n = idx - t * N;
      b_s[t * ldn + n] = Bm[(t0 + t) * N + n];
      c_s[t * ldn + n] = Cm[(t0 + t) * N + n];
    }
    if (tid < Q) dt_s[tid] = dt[(t0 + tid) * H + h];
    __syncthreads();
    // ---- cumulative decay (sequential, Q <= 64 adds)
    if (tid == 0) {
      float cum = 0.f;
      for (int t = 0; t < Q; ++t) {
        cum += dt_s[t] * a;
        cum_s[t] = cum;
      }
    }
    __syncthreads();
    const float total = cum_s[Q - 1];
    if (tid < Q) {
      ecum_s[tid] = expf(cum_s[tid]);
      w_s[tid] = expf(total - cum_s[tid]);
    }
    for (int idx = tid; idx < Q * P; idx += kThreads)
      xdt_s[idx] = x_s[idx] * dt_s[idx / P];
    // ---- G = (C Bᵀ) ⊙ Γ, causal select
    for (int idx = tid; idx < Q * Q; idx += kThreads) {
      const int i = idx / Q, j = idx - i * Q;
      float g = 0.f;
      if (j <= i) {
        const float* ci = c_s + i * ldn;
        const float* bj = b_s + j * ldn;
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(ci[n], bj[n], s);
        g = s * expf(cum_s[i] - cum_s[j]);
      }
      g_s[i * ldq + j] = g;
    }
    __syncthreads();
    // ---- y = G (dt x) + (C ⊙ exp(cum)) S + D x
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int i = idx / P, p = idx - i * P;
      const float* gi = g_s + i * ldq;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(gi[j], xdt_s[j * P + p], acc);
      const float* ci = c_s + i * ldn;
      const float e = ecum_s[i];
      float inter = 0.f;
      for (int n = 0; n < N; ++n)
        inter = fmaf(ci[n] * e, st_s[n * P + p], inter);
      acc = acc + inter;
      acc = acc + dskip * x_s[idx];
      y[((t0 + i) * H + h) * P + p] = acc;
    }
    __syncthreads();
    // ---- S = exp(total) S + (B ⊙ w)ᵀ (dt x)
    const float etot = expf(total);
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const int n = idx / P, p = idx - n * P;
      float acc = 0.f;
      for (int i = 0; i < Q; ++i)
        acc = fmaf(b_s[i * ldn + n] * w_s[i], xdt_s[i * P + p], acc);
      st_s[idx] = etot * st_s[idx] + acc;
    }
    __syncthreads();
  }
  if (state_out != nullptr) {
    float* out = state_out + (static_cast<long long>(b) * H + h) * N * P;
    for (int idx = tid; idx < N * P; idx += kThreads) out[idx] = st_s[idx];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every tensor is contiguous
// float32: x, y [Bt, L, H, P]; dt [Bt, L, H]; A, D [H]; B, C [Bt, L, N];
// state_out [Bt, H, N, P] or null.  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() (0 on
// success).  The caller guarantees Bt, L, H, P, N > 0, 0 < Q <= 64 and
// L % Q == 0.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, const void* D,
                          void* y, void* state_out, int Bt, int L, int H,
                          int P, int N, int Q, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxChunk || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * Q * P + 2 * Q * (N + 1) + Q * (Q + 1) + N * P + 4 * Q) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_kernel<<<Bt * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(state_out), L, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}
