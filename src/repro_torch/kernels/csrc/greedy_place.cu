// Greedy's placement in the dynamic simulator's event step, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The reference runs the same placement on
// the device as a fori_loop under jit (src/repro/core/vectorized/
// scheduling.py, make_bucket_greedy_placer, after bucket_transfer_costs);
// the port's plain version (repro_torch/core/vectorized/scheduling.py,
// greedy_place_plain) loops on the host over the placing tasks, whose
// count it reads from the device.  This kernel does both halves with no
// host read, so the whole event step replays from one CUDA graph:
//
//   * the transfer cost of each placing task on each worker: the sizes of
//     its input objects that are missing at the worker, summed over the
//     task's input edges in the edge table's order;
//   * the sequential placement: tasks in id order, each to the worker
//     with the least (cost, queued load, worker id) among the workers
//     with enough cores (every worker when none has), bumping the load
//     the next task sees.
//
// What bounds it on the H100: neither bytes nor operations.  A row reads
// its placing flags, the edge-table entries of its placing tasks and, per
// input edge, one object id, one size and W missing flags: a few KB.
// The time is the launch and a chain of dependent steps inside a row: a
// serial walk over the row's placing tasks (about 6 at the survey's
// pegasus shapes) and over the input edges of each.  So the design keeps
// that chain short:
//
//   * one warp owns one row, 4 rows per block; lane l holds workers l,
//     l + 32, ... (NW = ceil(W / 32) a lane), with their loads and core
//     counts in registers;
//   * the row's placing flags are read in 32-task chunks, all loads
//     issued before any is used, and kept as ballot words in shared
//     memory; the walk takes their set bits in id order;
//   * a task's input edges are read across the lanes, 32 at a time: lane
//     k loads edge k's object, size and the W missing flags of that
//     object (as NW bit words), all independent loads.  The per-worker
//     sum then takes the edges in order from the lanes by shuffles, so no
//     lane walks a chain of dependent global loads over the in-degree
//     (cybershake's gather task has 80 inputs);
//   * the choice is three warp reductions: the least cost over the
//     eligible workers (redux.sync over the floats' bits in the same
//     order), the least load among the workers at that cost, and the
//     first lane of a ballot; the chosen worker's lane bumps its load.
//
// Bitwise equality with the plain version is the target:
//   * each cost is 0 + size * missing over the edges in the table's
//     order, one __fmul_rn and one __fadd_rn an edge, as the plain
//     version's one add of size * missing an edge; a padded table entry
//     (-1) adds nothing, where the plain version adds +0.0 to a sum that
//     is never -0.0;
//   * ties go to the smaller load, then to the smaller worker id; a task
//     that fits no worker sees +inf everywhere and goes to the least
//     loaded worker, as the plain version's comparisons do.
//
// The placer's loop length of the plain version is the largest placing
// count over the rows.  The kernel adds that largest count to tally[0]
// once a launch: each warp takes an atomicMax into tally[1], and the last
// block to finish (a ticket in tally[2]) adds tally[1] to tally[0] and
// clears tally[1] and tally[2] for the next launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 4;          // rows (warps) a block
constexpr int kBig = 0x7fffffff;  // the plain version's BIG (int32 max)
constexpr size_t kMaxSmem = 48 * 1024;

// A float's bits as an int of the same order (every value but NaN; -0
// sorts below +0), and back: a min over floats as one integer redux.
__device__ __forceinline__ int ordered_bits(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int m) {
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

template <int NW>
__global__ void __launch_bounds__(32 * kRows)
greedy_place_kernel(const uint8_t* __restrict__ placing,   // [R, T]
                    const int64_t* __restrict__ table,     // [R, T, D]
                    const int64_t* __restrict__ e_obj,     // [R, E]
                    const float* __restrict__ size_now,    // [R, O]
                    const uint8_t* __restrict__ missing,   // [R, O, W]
                    const int64_t* __restrict__ cpus,      // [R, T]
                    const int64_t* __restrict__ cores,     // [R, W]
                    const int64_t* __restrict__ load0,     // [R, W]
                    int64_t* __restrict__ new_pw,          // [R, T]
                    unsigned long long* __restrict__ tally,  // [3]
                    int R, int T, int D, int E, int O, int W) {
  extern __shared__ unsigned smem_bits[];  // kRows x ceil(T / 32) words
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int row = blockIdx.x * kRows + wib;
  const int nchunks = (T + 31) / 32;
  unsigned placed = 0u;  // this row's placing count (every lane)

  if (row < R) {
    unsigned* bits = smem_bits + wib * nchunks;
    const long long tb = static_cast<long long>(row) * T;
    // the placing flags as ballot words; nothing placed yet
    for (int c = 0; c < nchunks; ++c) {
      const int t = 32 * c + lane;
      bool p = false;
      if (t < T) {
        p = placing[tb + t] != 0;
        new_pw[tb + t] = -1;
      }
      const unsigned b = __ballot_sync(kFull, p);
      if (lane == 0) bits[c] = b;
      placed += __popc(b);
    }
    __syncwarp();

    const long long wb = static_cast<long long>(row) * W;
    const long long ob = static_cast<long long>(row) * O;
    const long long eb = static_cast<long long>(row) * E;
    bool in[NW];
    long long core[NW];
    int load[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int w = 32 * j + lane;
      in[j] = w < W;
      core[j] = in[j] ? cores[wb + w] : 0;
      load[j] = in[j] ? static_cast<int>(load0[wb + w]) : 0;
    }

    for (int c = 0; placed && c < nchunks; ++c) {
      unsigned b = bits[c];
      while (b) {
        const int t = 32 * c + __ffs(b) - 1;
        b &= b - 1u;
        const long long ct = cpus[tb + t];
        const long long tab = (tb + t) * static_cast<long long>(D);

        // the cost on each of this lane's workers, edge by edge in the
        // table's order; valid entries lead, -1 padding trails
        float acc[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) acc[j] = 0.0f;
        for (int k0 = 0; k0 < D; k0 += 32) {
          const int k = k0 + lane;
          const long long id = k < D ? table[tab + k] : -1;
          const unsigned valid = __ballot_sync(kFull, id >= 0);
          const int n = __popc(valid);
          if (n == 0) break;
          float size = 0.0f;
          unsigned miss[NW];
#pragma unroll
          for (int j = 0; j < NW; ++j) miss[j] = 0u;
          if (id >= 0) {
            const long long obj = e_obj[eb + id];
            size = size_now[ob + obj];
            const uint8_t* m = missing + (ob + obj) * W;
            for (int w = 0; w < W; ++w)
              if (m[w]) miss[w >> 5] |= 1u << (w & 31);
          }
          for (int kk = 0; kk < n; ++kk) {
            const float s = __shfl_sync(kFull, size, kk);
#pragma unroll
            for (int j = 0; j < NW; ++j) {
              const unsigned mj = __shfl_sync(kFull, miss[j], kk);
              acc[j] = __fadd_rn(acc[j],
                                 __fmul_rn(s, (mj >> lane) & 1u ? 1.0f
                                                                : 0.0f));
            }
          }
          if (n < 32) break;
        }

        // least cost over the eligible workers (+inf where cores < cpus)
        float cost[NW];
        int best = kBig;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          cost[j] = core[j] >= ct ? acc[j] : CUDART_INF_F;
          if (in[j]) best = min(best, ordered_bits(cost[j]));
        }
        const float cmin = from_ordered(__reduce_min_sync(kFull, best));
        // ... then the least queued load among the workers at that cost
        bool cand[NW];
        int lmin = kBig;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          cand[j] = in[j] && cost[j] == cmin;
          if (cand[j]) lmin = min(lmin, load[j]);
        }
        lmin = __reduce_min_sync(kFull, lmin);
        // ... then the smallest worker id
        int wsel = -1;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const unsigned bal = __ballot_sync(kFull, cand[j] && load[j] == lmin);
          if (wsel < 0 && bal) wsel = 32 * j + __ffs(bal) - 1;
        }
        if (lane == 0) new_pw[tb + t] = wsel;
#pragma unroll
        for (int j = 0; j < NW; ++j)
          if (32 * j + lane == wsel) ++load[j];
      }
    }
    if (lane == 0 && placed) {
      atomicMax(&tally[1], static_cast<unsigned long long>(placed));
      __threadfence();
    }
  }

  // the launch's largest count, added once by the last block to finish
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long ticket = atomicAdd(&tally[2], 1ull);
    if (ticket == gridDim.x - 1) {
      __threadfence();
      tally[0] += atomicExch(&tally[1], 0ull);
      atomicExch(&tally[2], 0ull);
    }
  }
}

template <int NW>
int launch(const void* placing, const void* table, const void* e_obj,
           const void* size_now, const void* missing, const void* cpus,
           const void* cores, const void* load0, void* new_pw, void* tally,
           int R, int T, int D, int E, int O, int W, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(kRows) * ((T + 31) / 32) * sizeof(unsigned);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + kRows - 1) / kRows;
  greedy_place_kernel<NW><<<blocks, 32 * kRows, smem, st>>>(
      static_cast<const uint8_t*>(placing),
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(e_obj),
      static_cast<const float*>(size_now),
      static_cast<const uint8_t*>(missing), static_cast<const int64_t*>(cpus),
      static_cast<const int64_t*>(cores), static_cast<const int64_t*>(load0),
      static_cast<int64_t*>(new_pw),
      static_cast<unsigned long long*>(tally), R, T, D, E, O, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a shape it does not take
// (W > 512 workers, or T past the shared memory of the placing words).
// The caller guarantees R > 0, T > 0, W > 0, contiguous tensors, tally[1]
// and tally[2] at 0 (they are left at 0), and object and edge ids in
// range.
extern "C" int greedy_place_launch(const void* placing, const void* table,
                                   const void* e_obj, const void* size_now,
                                   const void* missing, const void* cpus,
                                   const void* cores, const void* load0,
                                   void* new_pw, void* tally, int R, int T,
                                   int D, int E, int O, int W,
                                   void* stream) {
  if (R <= 0 || T <= 0 || W <= 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (W + 31) / 32;
#define GREEDY_PLACE_LAUNCH(NW)                                              \
  return launch<NW>(placing, table, e_obj, size_now, missing, cpus, cores,   \
                    load0, new_pw, tally, R, T, D, E, O, W, st)
  if (words <= 1) GREEDY_PLACE_LAUNCH(1);
  if (words <= 2) GREEDY_PLACE_LAUNCH(2);
  if (words <= 4) GREEDY_PLACE_LAUNCH(4);
  if (words <= 8) GREEDY_PLACE_LAUNCH(8);
  if (words <= 16) GREEDY_PLACE_LAUNCH(16);
#undef GREEDY_PLACE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
