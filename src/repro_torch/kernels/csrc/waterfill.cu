// Batched max-min fair rates by progressive filling, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/waterfill.py::_waterfill_kernel
// (Pallas; wrapper waterfill_batch).  That kernel materialised a one-hot
// [F, 2W] flow->resource incidence and ran a fixed 2W rounds of matmuls on
// the MXU.  Here one thread block owns one row (one simulation's flow set)
// and one thread owns one flow:
//
//   * live-flow counts and frozen-flow use per resource are integer
//     atomicAdds into shared memory — exact in any order, so no incidence
//     matrix is built;
//   * the minimal share is a warp-shuffle min followed by a min over the
//     per-warp partials;
//   * the row leaves its round loop as soon as no live flow remains
//     (__syncthreads_or), bounded by max_rounds (2W by default).
//
// What bounds it on the H100: neither bytes nor operations.  A row reads
// F*9 bytes (src, dst i32 and active u8) plus 2W*4 bytes of capacities
// and writes F*4 bytes; at the survey's shape (F = 128, W = 32) that is
// under 2 KB and a few thousand operations per row.  The time is launch
// latency plus the serial rounds inside a row (each round is a handful of
// block-wide barriers).  The design keeps every round in shared memory and
// registers, exits a row early, and runs all rows of a batch in one
// launch (one block per row); fusing the solver into the simulator's
// event step is left for later.
//
// Bitwise equality with the plain PyTorch version
// (repro_torch/core/vectorized/waterfill.py) is the target:
//   * the reference threshold min_share * (1.0 + 1e-9) is a float32
//     multiply by a factor that rounds to 1.0f, so the test here is
//     share <= min_share, in float;
//   * cap - min_share * used is rounded once, as a fused multiply-add
//     (__fmaf_rn): the reference package's compiler contracts this
//     expression into an FMA, and the plain version reproduces that
//     rounding exactly (_ops.fma32).  Nothing else may be contracted, so
//     the build passes --fmad=false;
//   * the share is an IEEE division (__fdiv_rn); never build with
//     --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory layout (dynamic): int count[2W], int used[2W],
// float cap[2W], int is_bn[2W], float warp_part[32], float min_share.
__global__ void waterfill_kernel(const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const uint8_t* __restrict__ active,
                                 const float* __restrict__ caps_up,
                                 const float* __restrict__ caps_down,
                                 float* __restrict__ rates,
                                 int F, int W, int max_rounds) {
  extern __shared__ unsigned char smem_raw[];
  const int n_res = 2 * W;
  int* count = reinterpret_cast<int*>(smem_raw);
  int* used = count + n_res;
  float* cap = reinterpret_cast<float*>(used + n_res);
  int* is_bn = reinterpret_cast<int*>(cap + n_res);
  float* warp_part = reinterpret_cast<float*>(is_bn + n_res);
  float* min_slot = warp_part + 32;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const long long fbase = static_cast<long long>(row) * F;
  const long long wbase = static_cast<long long>(row) * W;

  // one flow per thread; flows whose worker ids fall outside [0, W)
  // touch no resource (the wrapper documents ids must be in range)
  bool act = false;
  int ru = 0, rd = 0;
  if (tid < F) {
    act = active[fbase + tid] != 0;
    ru = src[fbase + tid];
    rd = dst[fbase + tid];
    const bool in_range = ru >= 0 && ru < W && rd >= 0 && rd < W;
    act = act && in_range;
    rd += W;
  }
  bool frozen = !act;
  float rate = 0.0f;
  if (tid < n_res)
    cap[tid] = tid < W ? caps_up[wbase + tid] : caps_down[wbase + tid - W];

  int any_live = __syncthreads_or(act);
  for (int round = 0; round < max_rounds && any_live; ++round) {
    if (tid < n_res) {
      count[tid] = 0;
      used[tid] = 0;
    }
    __syncthreads();
    const bool live = act && !frozen;
    if (live) {
      atomicAdd(&count[ru], 1);
      atomicAdd(&count[rd], 1);
    }
    __syncthreads();

    float share = CUDART_INF_F;
    if (tid < n_res && count[tid] > 0)
      share = __fdiv_rn(cap[tid], static_cast<float>(count[tid]));
    float m = warp_min(share);
    if (lane == 0) warp_part[warp] = m;
    __syncthreads();
    if (warp == 0) {
      float v = lane < n_warps ? warp_part[lane] : CUDART_INF_F;
      v = warp_min(v);
      if (lane == 0) *min_slot = v;
    }
    __syncthreads();
    const float min_share = *min_slot;

    if (tid < n_res) is_bn[tid] = (count[tid] > 0) && (share <= min_share);
    __syncthreads();
    const bool freeze = live && (is_bn[ru] || is_bn[rd]);
    if (freeze) {
      rate = min_share;
      frozen = true;
      atomicAdd(&used[ru], 1);
      atomicAdd(&used[rd], 1);
    }
    __syncthreads();
    if (tid < n_res) {
      const float left = __fmaf_rn(-min_share,
                                   static_cast<float>(used[tid]), cap[tid]);
      cap[tid] = fmaxf(left, 0.0f);
    }
    // also the barrier that publishes cap before the next round
    any_live = __syncthreads_or(act && !frozen);
  }
  if (tid < F) rates[fbase + tid] = rate;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// (0 on success).  The caller guarantees R > 0, F > 0, W > 0 and
// max(F, 2W) <= 1024.
extern "C" int waterfill_launch(const void* src, const void* dst,
                                const void* active, const void* caps_up,
                                const void* caps_down, void* rates, int R,
                                int F, int W, int max_rounds, void* stream) {
  const int need = F > 2 * W ? F : 2 * W;
  if (R <= 0 || F <= 0 || W <= 0 || need > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((need + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(2 * W) * 16 + 33 * sizeof(float);
  waterfill_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const uint8_t*>(active),
      static_cast<const float*>(caps_up),
      static_cast<const float*>(caps_down), static_cast<float*>(rates), F, W,
      max_rounds);
  return static_cast<int>(cudaGetLastError());
}
