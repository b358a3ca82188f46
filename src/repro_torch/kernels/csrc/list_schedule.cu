// The static list schedule of the simulators, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference computes the schedule on the
// device as fori_loops under jit (src/repro/core/vectorized/scheduling.py:
// bucket_blevel, bucket_tlevel, _make_bucket_list_scheduler); the port's
// plain version (repro_torch/core/vectorized/scheduling.py,
// list_schedule_plain and list_priorities_plain) is two Python loops over
// the T tasks, each step a few dozen eager ops on the whole [R, ...]
// batch, issued from the host.  This kernel computes one simulator call's
// schedule in one launch, with no host read:
//
//   * the level: b-level by the reverse sweep over the id-topological
//     order (blevel, mcp), t-level by the forward sweep (tlevel), from
//     the estimated durations;
//   * the order: the stable rank of the key (-b-level, t-level, or
//     CP - b-level), ties to the smaller id; priority = T - rank;
//   * the placement (mode "place"; mode "priorities" stops before it):
//     the tasks in that order, each to the worker with the earliest
//     start, max(cpus-th smallest core free time, data ready), +inf where
//     the worker has too few cores, the first such worker on a tie; the
//     worker's `cpus` earliest core slots then take the finish time.
//
// What bounds it on the H100: neither bytes nor operations.  A row reads
// its edges, tasks and workers once (about 20 KB at T512) and does a few
// thousand operations a task; the time is a chain of dependent steps,
// serial over the row's T tasks in each sweep and in the placement.  So
// the design keeps each step short and on chip:
//
//   * one warp owns one row (one block of 32 threads); everything the
//     steps read lives in shared memory: the levels, finish times,
//     assigned workers, order, durations and cores of the tasks; per
//     edge its two ends and transfer time; the [W, C] core slots; and a
//     per-row edge list by task (counted, scanned and filled inside the
//     kernel: by producer for the b-level sweep, by consumer for the
//     t-level sweep and the placement);
//   * lane l holds workers l, l + 32, ... (NW = ceil(W / 32) a lane);
//     a task's input edges are read across the lanes, 32 at a time, and
//     handed to every lane by shuffles, so no lane walks a chain of
//     loads over the in-degree;
//   * maxima and the argmin are warp reductions over the floats' bits
//     in order-preserving integers (redux.sync), then a ballot for the
//     first worker at the minimum; the commit is one lane a core slot.
//
// Bitwise equality with the plain version is the target, on estimates
// that make no NaN (durations and sizes finite, bandwidth > 0):
//   * every sum is one __fadd_rn, the ALAP key one __fsub_rn, a transfer
//     time one IEEE division (--fmad=false, no fast math), as the plain
//     version rounds each once;
//   * a maximum over a task's edges starts at 0.0, as the plain
//     version's where(mask, ..., 0.0).amax over all E edges does, except
//     when all E edges of the row are the task's own (then no 0.0 takes
//     part); maxima and minima are exact in any order;
//   * ranks count, for each task, the keys below its own and the equal
//     keys of smaller ids: the stable sort's positions;
//   * the commit gives the ct earliest slots the finish time and merges
//     them into the rest, as the plain version's sort of the slot row.
//
// The caller guarantees 1 <= cpus <= C (the kernel clamps into [1, C]),
// edge ends and objects in range (an edge outside [0, T) counts as
// invalid), contiguous tensors.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 32;                 // one lane a core slot
constexpr int kMaxIds = 0xffff;           // task and edge ids in uint16
constexpr uint16_t kNone = 0xffff;        // an edge that takes no part
constexpr size_t kMaxSmem = 232448;       // 227 KB a block on the H100
constexpr int kBig = 0x7fffffff;

enum Order { kBlevel = 0, kTlevel = 1, kMcp = 2 };

// A float's bits as an int of the same order (every value but NaN; -0
// sorts below +0), and back: a min or max over floats as one redux.
__device__ __forceinline__ int ordered_bits(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int m) {
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_max(float v) {
  return from_ordered(__reduce_max_sync(kFull, ordered_bits(v)));
}

// The row's shared memory, carved from one dynamic allocation.
struct Row {
  float* lvl;      // [T] level, then the sort key
  float* fin;      // [T] finish times
  float* dur;      // [T] estimated durations
  float* xfer;     // [E] transfer time of each edge
  float* slots;    // [W * C] core free times, ascending per worker
  unsigned* off;   // [T + 1] edge list offsets by task
  uint16_t* aw;    // [T] assigned workers
  uint16_t* order; // [T] task of each rank
  uint16_t* ids;   // [E] the edge list
  uint16_t* cons;  // [E] consumer of each edge (kNone: invalid)
  uint16_t* prod;  // [E] producer of each edge
  uint8_t* cpus;   // [T] the tasks' cores, clamped into [1, C]
};

__host__ __device__ inline size_t smem_bytes(int T, int E, int WC) {
  return 4 * (3 * static_cast<size_t>(T) + E + WC) +
         4 * (static_cast<size_t>(T) + 1) + 2 * (2 * static_cast<size_t>(T) +
         3 * static_cast<size_t>(E)) + static_cast<size_t>(T);
}

__device__ inline Row carve(unsigned char* base, int T, int E, int WC) {
  Row s;
  s.lvl = reinterpret_cast<float*>(base);
  s.fin = s.lvl + T;
  s.dur = s.fin + T;
  s.xfer = s.dur + T;
  s.slots = s.xfer + E;
  s.off = reinterpret_cast<unsigned*>(s.slots + WC);
  s.aw = reinterpret_cast<uint16_t*>(s.off + T + 1);
  s.order = s.aw + T;
  s.ids = s.order + T;
  s.cons = s.ids + E;
  s.prod = s.cons + E;
  s.cpus = reinterpret_cast<uint8_t*>(s.prod + E);
  return s;
}

// The edge list of the row by task: the valid edges whose `key` end is
// t sit at ids[start(t), off[t]), start(t) = t ? off[t - 1] : 0 (the
// order inside a task's list is free: only maxima are taken over it).
__device__ void build_list(const Row& s, const uint16_t* key, int T, int E,
                           int lane) {
  for (int i = lane; i <= T; i += 32) s.off[i] = 0u;
  __syncwarp();
  for (int e = lane; e < E; e += 32)
    if (s.cons[e] != kNone) atomicAdd(&s.off[key[e] + 1], 1u);
  __syncwarp();
  unsigned carry = 0u;  // inclusive scan: off[t] = start of t
  for (int c = 0; c <= T; c += 32) {
    const int i = c + lane;
    unsigned v = i <= T ? s.off[i] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    if (i <= T) s.off[i] = v + carry;
    carry += __shfl_sync(kFull, v, 31);
  }
  __syncwarp();
  for (int e = lane; e < E; e += 32)
    if (s.cons[e] != kNone) s.ids[atomicAdd(&s.off[key[e]], 1u)] = e;
  __syncwarp();
}

// The start value of a maximum over task t's n listed edges: 0.0, as
// the plain version's where(mask, v, 0.0).amax over all E edges gives,
// unless all E edges are the task's.
__device__ __forceinline__ float max_start(int n, int E) {
  return E > 0 && n == E ? -CUDART_INF_F : 0.0f;
}

template <int NW>
__global__ void __launch_bounds__(32)
list_schedule_kernel(const int64_t* __restrict__ e_task,     // [R, E]
                     const int64_t* __restrict__ prod_e,     // [R, E]
                     const int64_t* __restrict__ e_obj,      // [R, E]
                     const uint8_t* __restrict__ edge_valid, // [R, E]
                     const int64_t* __restrict__ cpus,       // [R, T]
                     const float* __restrict__ est_dur,      // [R, T]
                     const float* __restrict__ est_size,     // [R, O]
                     const float* __restrict__ bandwidth,    // [R]
                     const int64_t* __restrict__ cores,      // [R, W]
                     int64_t* __restrict__ aw_out,           // [R, T]
                     float* __restrict__ prio,               // [R, T]
                     int T, int E, int O, int W, int C, int order,
                     int place) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const Row s = carve(smem, T, E, place ? W * C : 0);
  const long long tb = static_cast<long long>(row) * T;
  const long long eb = static_cast<long long>(row) * E;

  // ---- the row's tasks and edges into shared memory
  for (int t = lane; t < T; t += 32) {
    s.lvl[t] = 0.0f;
    s.fin[t] = 0.0f;
    s.aw[t] = 0;
    s.dur[t] = est_dur[tb + t];
    if (place) {
      const long long c = cpus[tb + t];
      s.cpus[t] = static_cast<uint8_t>(c < 1 ? 1 : (c > C ? C : c));
    }
  }
  const float bw = place ? bandwidth[row] : 0.0f;
  const long long ob = static_cast<long long>(row) * O;
  for (int e = lane; e < E; e += 32) {
    const long long c = e_task[eb + e], p = prod_e[eb + e];
    const bool ok = edge_valid[eb + e] && c >= 0 && c < T && p >= 0 && p < T;
    s.cons[e] = ok ? static_cast<uint16_t>(c) : kNone;
    s.prod[e] = ok ? static_cast<uint16_t>(p) : kNone;
    if (place && ok) {
      const long long o = e_obj[eb + e];
      s.xfer[e] = (o >= 0 && o < O) ? __fdiv_rn(est_size[ob + o], bw) : 0.0f;
    }
  }
  __syncwarp();

  // ---- the level
  if (order == kTlevel) {
    build_list(s, s.cons, T, E, lane);
    for (int t = 0; t < T; ++t) {
      const int b = t ? s.off[t - 1] : 0, n = s.off[t] - b;
      float m = max_start(n, E);
      for (int k = lane; k < n; k += 32) {
        const int p = s.prod[s.ids[b + k]];
        const float v = __fadd_rn(s.lvl[p], s.dur[p]);
        m = v > m ? v : m;
      }
      m = warp_max(m);
      if (lane == 0) s.lvl[t] = m;
      __syncwarp();
    }
  } else {
    build_list(s, s.prod, T, E, lane);
    for (int t = T - 1; t >= 0; --t) {
      const int b = t ? s.off[t - 1] : 0, n = s.off[t] - b;
      float m = max_start(n, E);
      for (int k = lane; k < n; k += 32) {
        const float v = s.lvl[s.cons[s.ids[b + k]]];
        m = v > m ? v : m;
      }
      m = warp_max(m);
      if (lane == 0) s.lvl[t] = __fadd_rn(s.dur[t], m);
      __syncwarp();
    }
  }

  // ---- the key, the order and the priorities
  if (order == kBlevel) {
    for (int t = lane; t < T; t += 32) s.lvl[t] = -s.lvl[t];
  } else if (order == kMcp) {
    float cp = -CUDART_INF_F;
    for (int t = lane; t < T; t += 32) cp = s.lvl[t] > cp ? s.lvl[t] : cp;
    cp = warp_max(cp);
    for (int t = lane; t < T; t += 32) s.lvl[t] = __fsub_rn(cp, s.lvl[t]);
  }
  __syncwarp();
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const float kt = t < T ? s.lvl[t] : 0.0f;
    int rank = 0;
    for (int u = 0; u < T; ++u) {
      const float ku = s.lvl[u];
      rank += (ku < kt) | ((ku == kt) & (u < t));
    }
    if (t < T) {
      s.order[rank] = static_cast<uint16_t>(t);
      prio[tb + t] = static_cast<float>(T - rank);
    }
  }
  __syncwarp();
  if (!place) return;

  // ---- the placement
  if (order != kTlevel) build_list(s, s.cons, T, E, lane);
  const long long wb = static_cast<long long>(row) * W;
  for (int i = lane; i < W * C; i += 32)
    s.slots[i] = (i % C) < cores[wb + i / C] ? 0.0f : CUDART_INF_F;
  bool in[NW];
  long long core[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = 32 * j + lane;
    in[j] = w < W;
    core[j] = in[j] ? cores[wb + w] : 0;
  }
  __syncwarp();

  for (int r = 0; r < T; ++r) {
    const int t = s.order[r];
    const int ct = s.cpus[t];
    const int b = t ? s.off[t - 1] : 0, n = s.off[t] - b;

    // data ready on each of this lane's workers: the latest input,
    // without its transfer where the producer ran on the worker
    float acc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = max_start(n, E);
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      float r0 = 0.0f, rx = 0.0f;
      int pw = -1;
      if (k < n) {
        const int e = s.ids[b + k], p = s.prod[e];
        const float pf = s.fin[p];
        pw = s.aw[p];
        r0 = __fadd_rn(pf, 0.0f);
        rx = __fadd_rn(pf, s.xfer[e]);
      }
      const int m = min(32, n - k0);
      for (int kk = 0; kk < m; ++kk) {
        const float a = __shfl_sync(kFull, r0, kk);
        const float x = __shfl_sync(kFull, rx, kk);
        const int q = __shfl_sync(kFull, pw, kk);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const float v = q == 32 * j + lane ? a : x;
          acc[j] = v > acc[j] ? v : acc[j];
        }
      }
    }

    // the earliest start, +inf where the worker has too few cores
    float est[NW];
    int best = kBig;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int w = 32 * j + lane;
      const float cr = in[j] ? s.slots[w * C + ct - 1] : CUDART_INF_F;
      const float e = cr > acc[j] ? cr : acc[j];
      est[j] = in[j] && core[j] >= ct ? e : CUDART_INF_F;
      if (in[j]) best = min(best, ordered_bits(est[j]));
    }
    const float lo = from_ordered(__reduce_min_sync(kFull, best));
    int wsel = -1;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const unsigned bal = __ballot_sync(kFull, in[j] && est[j] == lo);
      if (wsel < 0 && bal) wsel = 32 * j + __ffs(bal) - 1;
    }
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j == (wsel >> 5)) mine = est[j];
    const float finish =
        __fadd_rn(__shfl_sync(kFull, mine, wsel & 31), s.dur[t]);

    // the ct earliest slots take the finish time; the row stays sorted
    float* slot = s.slots + wsel * C;
    const float old = lane < C ? slot[lane] : CUDART_INF_F;
    const int below = __popc(
        __ballot_sync(kFull, lane >= ct && lane < C && old < finish));
    const float from = __shfl_sync(kFull, old, min(ct + lane, 31));
    if (lane < C)
      slot[lane] = lane < below ? from : (lane < below + ct ? finish : old);
    if (lane == 0) {
      s.aw[t] = static_cast<uint16_t>(wsel);
      s.fin[t] = finish;
      aw_out[tb + t] = wsel;
    }
    __syncwarp();
  }
}

template <int NW>
int launch(const void* e_task, const void* prod_e, const void* e_obj,
           const void* edge_valid, const void* cpus, const void* est_dur,
           const void* est_size, const void* bandwidth, const void* cores,
           void* aw, void* prio, int R, int T, int E, int O, int W, int C,
           int order, int place, cudaStream_t st) {
  const size_t smem = smem_bytes(T, E, place ? W * C : 0);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        list_schedule_kernel<NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  list_schedule_kernel<NW><<<R, 32, smem, st>>>(
      static_cast<const int64_t*>(e_task), static_cast<const int64_t*>(prod_e),
      static_cast<const int64_t*>(e_obj),
      static_cast<const uint8_t*>(edge_valid),
      static_cast<const int64_t*>(cpus), static_cast<const float*>(est_dur),
      static_cast<const float*>(est_size),
      static_cast<const float*>(bandwidth),
      static_cast<const int64_t*>(cores), static_cast<int64_t*>(aw),
      static_cast<float*>(prio), T, E, O, W, C, order, place);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a shape it does not take (T
// or E past 65535, W past 512, C past 32, or a row's shared memory past
// 227 KB).  With place = 0 it writes the priorities alone, and e_obj,
// est_size, bandwidth, cpus, cores and aw are not read (W and C are 0).
// The caller guarantees R > 0, T > 0, contiguous tensors.
extern "C" int list_schedule_launch(const void* e_task, const void* prod_e,
                                    const void* e_obj,
                                    const void* edge_valid,
                                    const void* cpus, const void* est_dur,
                                    const void* est_size,
                                    const void* bandwidth,
                                    const void* cores, void* aw, void* prio,
                                    int R, int T, int E, int O, int W, int C,
                                    int order, int place, void* stream) {
  if (R <= 0 || T <= 0 || E < 0 || T > kMaxIds || E > kMaxIds ||
      order < kBlevel || order > kMcp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (place && (W <= 0 || C <= 0 || C > kMaxC))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = place ? (W + 31) / 32 : 1;
#define LIST_SCHEDULE_LAUNCH(NW)                                             \
  return launch<NW>(e_task, prod_e, e_obj, edge_valid, cpus, est_dur,       \
                    est_size, bandwidth, cores, aw, prio, R, T, E, O, W, C, \
                    order, place, st)
  if (words <= 1) LIST_SCHEDULE_LAUNCH(1);
  if (words <= 2) LIST_SCHEDULE_LAUNCH(2);
  if (words <= 4) LIST_SCHEDULE_LAUNCH(4);
  if (words <= 8) LIST_SCHEDULE_LAUNCH(8);
  if (words <= 16) LIST_SCHEDULE_LAUNCH(16);
#undef LIST_SCHEDULE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
