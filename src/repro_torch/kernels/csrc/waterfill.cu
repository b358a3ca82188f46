// Batched max-min fair rates by progressive filling, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/waterfill.py::_waterfill_kernel
// (Pallas; wrapper waterfill_batch).  That kernel materialised a one-hot
// [F, 2W] flow->resource incidence and ran a fixed 2W rounds of matmuls on
// the MXU.  Each row here (one simulation's flow set) runs its own rounds
// of count -> share -> min -> freeze -> subtract and stops as soon as no
// flow of the row is live, bounded by max_rounds (2W by default).
//
// What bounds it on the H100: neither bytes nor operations.  A row reads
// F*9 bytes (src, dst i32 and active u8) plus 2W*4 bytes of capacities
// and writes F*4 bytes; at the survey's shape (F = 128, W = 32) that is
// under 2 KB and a few thousand operations per row.  The time is launch
// latency plus the chain of dependent steps in a row's rounds, one round
// per distinct bottleneck level.  So the design cuts the latency of a
// round, in two routes picked by the wrapper from (F, W):
//
//   * warp route (F <= 128, W <= 32: every survey shape, F = 4W): one warp
//     owns one row, 4 rows per block of 128 threads, so R 4096 is one wave
//     on 132 SMs and no block barrier is ever taken.  Lane l holds flows
//     l, l+32, l+64, l+96 (their rates in registers) and the resources l
//     (upload) and W + l (download), each with its capacity in a
//     register.  Before the rounds, each lane builds the bitmask of the
//     flows that use each of its resources (shared-memory atomicOr into
//     the warp's own slice, once per row).  The live flows are a bitmask
//     too (one word per 32 flows, the same in every lane), so a round is
//     registers and warp reductions only, each step one instruction deep:
//       - frozen use per resource: popcounts of (resource mask & frozen
//         mask), exact integers; the live counts are the masks' popcounts
//         less the use, round by round;
//       - the shares: every lane divides, so no branch splits the warp;
//       - the row's minimal share: one redux.sync min over the shares'
//         bits mapped to integers of the same order;
//       - the frozen flows: one redux.sync OR per 32 flows of the masks
//         of the bottleneck resources, and'ed with the live mask (a live
//         flow freezes if its upload or its download is a bottleneck);
//         it also clears them from the live mask, and the row leaves when
//         no bit is left.
//     (A first version took the min in 5 shuffle steps and found the
//     frozen flows by ballots of per-flow tests; PERF.md has the times of
//     both.)
//   * block route (2W > 64 or F > 128, up to 2W <= 1024 and any F whose
//     live bits fit shared memory): one block owns one row, one thread
//     each resource and ceil(F / blockDim) flows (the per-edge simulator
//     solves F = E flows: 2016 at the T2048 bucket); integer
//     shared-memory atomicAdds for the counts, a two-level min, block
//     barriers between the steps of a round.
//
// Bitwise equality with the plain PyTorch version
// (repro_torch/core/vectorized/waterfill.py) is the target on both
// routes:
//   * counts and use are exact integers, converted once to float;
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
// Flows whose worker ids fall outside [0, W) are treated as inactive and
// touch no resource.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// the block route's dynamic shared memory without an opt-in: 2W <= 1024
// takes 16 KB, which leaves room for the live bits of 250k flows
constexpr size_t kMaxSmem = 48 * 1024;
// warp route: rows per block, and the largest F and W it takes
constexpr int kWarpRows = 4;
constexpr int kWarpMaxSlots = 4;  // flows per lane: F <= 128
constexpr int kWarpMaxW = 32;     // one upload and one download per lane

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// A float's bits as an int of the same order (for every value but NaN;
// -0 sorts below +0), and back: min over floats as one integer redux.
__device__ __forceinline__ int ordered_bits(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float warp_min_redux(float v) {
  const int m = __reduce_min_sync(kFull, ordered_bits(v));
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// One warp per row; NK = ceil(F / 32) flows per lane.
template <int NK>
__global__ void __launch_bounds__(32 * kWarpRows)
waterfill_warp_kernel(const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      const uint8_t* __restrict__ active,
                      const float* __restrict__ caps_up,
                      const float* __restrict__ caps_down,
                      float* __restrict__ rates, int R, int F, int W,
                      int max_rounds) {
  // per warp: the flows of each upload / download resource, as NK words
  __shared__ unsigned masks[kWarpRows][2][kWarpMaxW][NK];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpRows + wib;
  if (row >= R) return;  // the whole warp: nothing below syncs the block
  const long long fbase = static_cast<long long>(row) * F;
  const long long wbase = static_cast<long long>(row) * W;
  unsigned(*up)[NK] = masks[wib][0];
  unsigned(*down)[NK] = masks[wib][1];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    up[lane][k] = 0u;
    down[lane][k] = 0u;
  }
  __syncwarp();

  // every load first, so that their latencies overlap; only the last
  // slot of flows can run past F
  int u[NK], v[NK];
  bool act[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int f = 32 * k + lane;
    u[k] = v[k] = -1;
    act[k] = false;
    if (k < NK - 1 || f < F) {
      u[k] = src[fbase + f];
      v[k] = dst[fbase + f];
      act[k] = active[fbase + f] != 0;
    }
  }
  float cap_u = lane < W ? caps_up[wbase + lane] : 0.0f;
  float cap_d = lane < W ? caps_down[wbase + lane] : 0.0f;

  unsigned live[NK];  // bit l of live[k]: flow 32k + l is live (all lanes)
  float rate[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    act[k] = act[k] && u[k] >= 0 && u[k] < W && v[k] >= 0 && v[k] < W;
    if (act[k]) {
      atomicOr(&up[u[k]][k], 1u << lane);
      atomicOr(&down[v[k]][k], 1u << lane);
    }
    live[k] = __ballot_sync(kFull, act[k]);
    rate[k] = 0.0f;
  }
  __syncwarp();
  unsigned mu[NK], md[NK];  // this lane's resources: the flows using them
  int cu = 0, cd = 0;       // ... and how many of them are live
  unsigned any = 0u;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    mu[k] = up[lane][k];
    md[k] = down[lane][k];
    cu += __popc(mu[k]);
    cd += __popc(md[k]);
    any |= live[k];
  }

  for (int round = 0; round < max_rounds && any; ++round) {
    // every lane divides (1 / 1 where a resource has no live flow), so
    // no branch splits the warp around the division
    const float qu = __fdiv_rn(cu > 0 ? cap_u : 1.0f,
                               static_cast<float>(cu > 0 ? cu : 1));
    const float qd = __fdiv_rn(cd > 0 ? cap_d : 1.0f,
                               static_cast<float>(cd > 0 ? cd : 1));
    const float su = cu > 0 ? qu : CUDART_INF_F;
    const float sd = cd > 0 ? qd : CUDART_INF_F;
    const float min_share = warp_min_redux(fminf(su, sd));
    const bool bn_u = cu > 0 && su <= min_share;
    const bool bn_d = cd > 0 && sd <= min_share;
    int uu = 0, ud = 0;
    any = 0u;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const unsigned z = live[k] & __reduce_or_sync(
          kFull, (bn_u ? mu[k] : 0u) | (bn_d ? md[k] : 0u));
      if ((z >> lane) & 1u) rate[k] = min_share;
      uu += __popc(mu[k] & z);
      ud += __popc(md[k] & z);
      live[k] &= ~z;
      any |= live[k];
    }
    cu -= uu;
    cd -= ud;
    cap_u = fmaxf(__fmaf_rn(-min_share, static_cast<float>(uu), cap_u),
                  0.0f);
    cap_d = fmaxf(__fmaf_rn(-min_share, static_cast<float>(ud), cap_d),
                  0.0f);
  }
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int f = 32 * k + lane;
    if (f < F) rates[fbase + f] = rate[k];
  }
}

// One block per row; thread t owns flows t, t + blockDim, t + 2 blockDim,
// ... (ceil(F / blockDim) of them), so F has no bound of its own.  Shared
// memory (dynamic): int count[2W], int used[2W], float cap[2W],
// int is_bn[2W], float warp_part[32], float min_share, and the live set as
// bits: word k * blockDim / 32 + warp, bit lane, for flow k * blockDim +
// tid (one warp writes each word, by ballot, so no atomics).  The flows'
// worker ids are read again from global memory in each pass (L1 hits).
__global__ void waterfill_block_kernel(const int32_t* __restrict__ src,
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
  unsigned* live_bits = reinterpret_cast<unsigned*>(min_slot + 1);

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;  // blockDim is a multiple of 32
  const int passes = (F + blockDim.x - 1) / blockDim.x;
  const long long fbase = static_cast<long long>(row) * F;
  const long long wbase = static_cast<long long>(row) * W;

  // the live flows: active, with both worker ids in range; rates start
  // at 0 and a flow's rate is written once, when it freezes
  bool any = false;
  for (int k = 0; k < passes; ++k) {
    const int f = k * blockDim.x + tid;
    bool act = false;
    if (f < F) {
      const int u = src[fbase + f];
      const int v = dst[fbase + f];
      act = active[fbase + f] != 0 && u >= 0 && u < W && v >= 0 && v < W;
      rates[fbase + f] = 0.0f;
    }
    const unsigned bits = __ballot_sync(kFull, act);
    if (lane == 0) live_bits[k * n_warps + warp] = bits;
    any = any || bits != 0u;
  }
  if (tid < n_res)
    cap[tid] = tid < W ? caps_up[wbase + tid] : caps_down[wbase + tid - W];

  int any_live = __syncthreads_or(any);
  for (int round = 0; round < max_rounds && any_live; ++round) {
    if (tid < n_res) {
      count[tid] = 0;
      used[tid] = 0;
    }
    __syncthreads();
    for (int k = 0; k < passes; ++k) {
      if ((live_bits[k * n_warps + warp] >> lane) & 1u) {
        const int f = k * blockDim.x + tid;
        atomicAdd(&count[src[fbase + f]], 1);
        atomicAdd(&count[W + dst[fbase + f]], 1);
      }
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
    any = false;
    for (int k = 0; k < passes; ++k) {
      const unsigned word = live_bits[k * n_warps + warp];
      bool freeze = false;
      if ((word >> lane) & 1u) {
        const int f = k * blockDim.x + tid;
        const int ru = src[fbase + f];
        const int rd = W + dst[fbase + f];
        freeze = is_bn[ru] || is_bn[rd];
        if (freeze) {
          rates[fbase + f] = min_share;
          atomicAdd(&used[ru], 1);
          atomicAdd(&used[rd], 1);
        }
      }
      // every lane has read the word before the ballot; lane 0 writes it
      const unsigned left = word & ~__ballot_sync(kFull, freeze);
      if (lane == 0) live_bits[k * n_warps + warp] = left;
      any = any || left != 0u;
    }
    __syncthreads();
    if (tid < n_res) {
      const float left = __fmaf_rn(-min_share,
                                   static_cast<float>(used[tid]), cap[tid]);
      cap[tid] = fmaxf(left, 0.0f);
    }
    // also the barrier that publishes cap and the live set before the
    // next round
    any_live = __syncthreads_or(any);
  }
}

template <int NK>
void launch_warp(const void* src, const void* dst, const void* active,
                 const void* caps_up, const void* caps_down, void* rates,
                 int R, int F, int W, int max_rounds, cudaStream_t stream) {
  const int blocks = (R + kWarpRows - 1) / kWarpRows;
  waterfill_warp_kernel<NK><<<blocks, 32 * kWarpRows, 0, stream>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const uint8_t*>(active),
      static_cast<const float*>(caps_up),
      static_cast<const float*>(caps_down), static_cast<float*>(rates), R, F,
      W, max_rounds);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  route 0 is the warp route
// (F <= 128, W <= 32), route 1 the block route (2W <= 1024, any F).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the route does not take.  The caller guarantees R > 0, F > 0, W > 0.
extern "C" int waterfill_launch(const void* src, const void* dst,
                                const void* active, const void* caps_up,
                                const void* caps_down, void* rates, int R,
                                int F, int W, int max_rounds, int route,
                                void* stream) {
  if (R <= 0 || F <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (F > 32 * kWarpMaxSlots || W > kWarpMaxW)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((F + 31) / 32) {
      case 1:
        launch_warp<1>(src, dst, active, caps_up, caps_down, rates, R, F, W,
                       max_rounds, st);
        break;
      case 2:
        launch_warp<2>(src, dst, active, caps_up, caps_down, rates, R, F, W,
                       max_rounds, st);
        break;
      case 3:
        launch_warp<3>(src, dst, active, caps_up, caps_down, rates, R, F, W,
                       max_rounds, st);
        break;
      default:
        launch_warp<4>(src, dst, active, caps_up, caps_down, rates, R, F, W,
                       max_rounds, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  // one thread per resource; up to one per flow, and no more than a block
  if (2 * W > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  int need = F > 2 * W ? F : 2 * W;
  if (need > kMaxThreads) need = kMaxThreads;
  const int threads = ((need + 31) / 32) * 32;
  const int passes = (F + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(2 * W) * 16 + 33 * sizeof(float) +
                      static_cast<size_t>(passes) * (threads / 32) *
                          sizeof(unsigned);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  waterfill_block_kernel<<<R, threads, smem, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const uint8_t*>(active),
      static_cast<const float*>(caps_up),
      static_cast<const float*>(caps_down), static_cast<float*>(rates), F, W,
      max_rounds);
  return static_cast<int>(cudaGetLastError());
}
