// Blocked online-softmax GQA attention with causal and sliding-window
// masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (Pallas; wrapper flash_attention).  That kernel tiled q
// and k/v into VMEM by BlockSpec, ran the kv axis as the sequential grid
// dimension and needed every shape and mask parameter static.  Here the
// function is attention_ref's, with the Pallas kernel's online softmax:
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D], any strides with a unit head
//   dim stride; q head h reads kv head h / (Hq / Hkv); query i sits at
//   absolute position q_pos = i + kv_len - Sq; key k is visible when
//   k < kv_len, k <= q_pos (causal) and k > q_pos - window (window > 0).
//   causal, window, kv_len and scale are run-time arguments, so one
//   build serves prefill (Sq = kv_len) and decode (Sq = 1) on every
//   layer's window.
//
// Layout of the work: one warp owns one query row; a block holds
// kRows rows that share one kv head (rows enumerate (position, head in
// the GQA group), position-major, so at decode the group's heads share
// one block and each K/V tile is read once for all of them).  Tiles of
// kTile = 32 keys are staged in shared memory as float32, rows padded
// by one word so lane j reading key j is free of bank conflicts.  For
// the scores each lane takes one key of the tile; for the accumulator
// each lane takes the head dims lane, lane + 32, ...  Tiles wholly
// outside the block's visible key range [q_lo - window + 1,
// min(q_hi, kv_len - 1)] are never loaded.
//
// Semantics kept from the Pallas kernel: float32 m, l and acc; masked
// scores are -1e30 and their p is zeroed; l is floored at 1e-30; the
// output is cast to q's type.  Skipping a tile with no visible key is
// exact: such a tile leaves m, l and acc unchanged.
//
// What bounds it on the H100: at prefill the operations (4 D flops per
// visible (query, key) pair), at decode the bytes of the KV cache.  This
// first version computes in float32 on the CUDA cores (no tensor cores,
// no TMA, no split over keys), so it runs far above its bound; the
// measured times are in PERF.md.  Explicit fmaf keeps the dot products
// fused although the port builds with --fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;    // query rows (warps) per block
constexpr int kTile = 32;   // keys per shared-memory tile (one per lane)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {     // element strides of the [B, H, S] dims (D is unit)
  long long b, h, s;
};

// Shared memory (dynamic): K tile [kTile][D+1], V tile [kTile][D+1],
// q rows [kRows][D], all float32.
template <typename T, int D>
__global__ void __launch_bounds__(kRows * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int Hq, int Hkv, int Sq,
             int Skv, int kv_len, int causal, int window, float scale) {
  constexpr int kDpl = (D + 31) / 32;   // head dims per lane
  constexpr int kLd = D + 1;            // padded tile row
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;

  const int group = Hq / Hkv;
  const int rows_total = group * Sq;
  // blockIdx.x: row block; blockIdx.y: b * Hkv + kv head
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = row0 + warp;
  const bool active = row < rows_total;
  const int qi = active ? row / group : 0;
  const int hq = hk * group + (active ? row % group : 0);
  const int q_pos = qi + kv_len - Sq;

  // visible key range of the whole block
  const int last_row = min(row0 + kRows, rows_total) - 1;
  const int pos_lo = row0 / group + kv_len - Sq;
  const int pos_hi = last_row / group + kv_len - Sq;
  int k_lo = 0;
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  int k_hi = kv_len - 1;
  if (causal) k_hi = min(k_hi, pos_hi);

  // this row's query, float32 in shared memory
  if (active) {
    const T* qrow = q + b * qs.b + hq * qs.h + qi * qs.s;
    for (int d = lane; d < D; d += 32) q_s[warp * D + d] = to_f32(qrow[d]);
  }
  // this row's own visible range (warp-uniform skip of a tile)
  int r_lo = 0, r_hi = kv_len - 1;
  if (window > 0) r_lo = max(0, q_pos - window + 1);
  if (causal) r_hi = min(r_hi, q_pos);

  float m = kNegInf, l = 0.f;
  float acc[kDpl];
#pragma unroll
  for (int i = 0; i < kDpl; ++i) acc[i] = 0.f;

  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;
  if (k_hi >= k_lo) {
    for (int t0 = (k_lo / kTile) * kTile; t0 <= k_hi; t0 += kTile) {
      __syncthreads();   // previous tile fully consumed (and q_s written)
      for (int idx = threadIdx.x; idx < kTile * D; idx += kRows * 32) {
        const int j = idx / D, d = idx - j * D;
        const int key = t0 + j;
        float kv = 0.f, vv = 0.f;
        if (key < Skv) {
          kv = to_f32(kbase[key * ks.s + d]);
          vv = to_f32(vbase[key * vs.s + d]);
        }
        k_s[j * kLd + d] = kv;
        v_s[j * kLd + d] = vv;
      }
      __syncthreads();
      if (!active || t0 > r_hi || t0 + kTile - 1 < r_lo) continue;

      const int key = t0 + lane;
      bool vis = key < kv_len;
      if (causal) vis = vis && key <= q_pos;
      if (window > 0) vis = vis && key > q_pos - window;
      float s = 0.f;
      const float* krow = k_s + lane * kLd;
      const float* qrow = q_s + warp * D;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      s = vis ? s * scale : kNegInf;

      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = vis ? expf(s - m_new) : 0.f;
      l = alpha * l + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = v_s + j * kLd;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) {
          const int d = lane + 32 * i;
          if (D % 32 == 0 || d < D) acc[i] = fmaf(pj, vrow[d], acc[i]);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + b * os.b + hq * os.h + qi * os.s;
#pragma unroll
  for (int i = 0; i < kDpl; ++i) {
    const int d = lane + 32 * i;
    if (D % 32 == 0 || d < D) store(orow + d, acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int Hkv, int Sq, int Skv,
           int kv_len, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = (2 * kTile * (D + 1) + kRows * D) * sizeof(float);
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int rows_total = (Hq / Hkv) * Sq;
  dim3 grid((rows_total + kRows - 1) / kRows, B * Hkv);
  kern<<<grid, kRows * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Hq, Hkv,
      Sq, Skv, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int Hq, int Hkv, int Sq, int Skv,
               int D, int kv_len, int causal, int window, float scale,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv,
                                  kv_len, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv,
                                  kv_len, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv,
                                  kv_len, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv,
                                    kv_len, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16
// (q, k, v and o share it).  strides: 12 element strides, the (b, h, s)
// strides of q, k, v and o in that order; the head dim is contiguous.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success).  The caller guarantees B, Hq, Hkv,
// Sq > 0, Hq % Hkv == 0, 0 < kv_len <= Skv and Sq <= kv_len.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int dtype,
                                      int B, int Hq, int Hkv, int Sq,
                                      int Skv, int D, int kv_len, int causal,
                                      int window, float scale,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Hq % Hkv != 0 ||
      kv_len <= 0 || kv_len > Skv || Sq > kv_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, D,
                             kv_len, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, strides, B, Hq, Hkv, Sq,
                                     Skv, D, kv_len, causal, window, scale,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
