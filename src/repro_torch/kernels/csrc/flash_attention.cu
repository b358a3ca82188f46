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
// Semantics kept from the Pallas kernel on every route: float32 m, l and
// acc; masked scores are -1e30 and their p is zeroed; l is floored at
// 1e-30; the output is cast to q's type.  Skipping a tile (or a split)
// with no visible key is exact: it leaves m, l and acc unchanged.
//
// Three routes, picked by the wrapper from the dtype and Sq alone:
//
// * f32 (float32, any Sq): flash_kernel<float, D>, unchanged from the
//   first port.  One warp per query row, 8 rows of one kv head per
//   block, 32-key tiles as float32 in shared memory, dot products by
//   fmaf on the CUDA cores.  float32 stays off the tensor cores on
//   purpose: they would take it only as TF32 (about three decimal
//   digits), and this route is the check held at 1e-5.
// * tc (bfloat16, Sq > 1, the prefill): flash_tc_kernel<D>.  Bound by
//   operations (4 D flops per visible (query, key) pair; at Hymba's
//   prefill about 27 GFLOP, 0.027 ms at 989 TFLOP/s).  One block of 4
//   warps takes 64 query rows of one q head (16 rows per warp), loads
//   them once, and walks 64-key tiles of its kv head: S = Q K^T and
//   O += P V on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//   accumulators, P rounded to bf16 for the product), operands from
//   shared memory by ldmatrix (V transposed by ldmatrix.trans).  K/V
//   tiles stream through a ring of 2 stages filled by 16-byte cp.async
//   copies, so the next tile's copy overlaps this tile's math.
//   Rows of shared memory are XOR-swizzled by 16-byte chunk, so
//   ldmatrix reads are free of bank conflicts (at D 160 the 64-byte tail
//   of each row is swizzled within itself; see swz).  Tiles wholly outside the
//   block's visible key range are never loaded; only tiles that cross
//   the diagonal, the window's edge or kv_len evaluate the mask.
//   Online softmax runs on the accumulator fragments in the base-2
//   domain (scores times scale * log2 e, the SFU's ex2.approx: with
//   IEEE exp2f the exponentials, not the products, set the pace).  At
//   D <= 64 registers are capped at 128 so 4 blocks share an SM.  Row
//   tiles are issued last-first, so the long causal rows start early.
// * split (bfloat16, Sq == 1, the decode): flash_split_kernel<D> and
//   flash_combine_kernel.  Bound by the bytes of the KV cache (at
//   Hymba's decode about 5 MB, 1.6-2.4 us at 3.35 TB/s); one block per
//   kv head would leave most of the 132 SMs idle, so the visible key
//   range is split into `splits` contiguous ranges planned on the host
//   (grid splits x B*Hkv x ceil(group / 8)).  A block takes all query
//   heads of its kv head (up to 8), so each K/V row is read once for
//   the group.  Each key is read as 16-byte vectors, one per lane, by
//   D / 8 neighbouring lanes, a power of two that tiles the warp (at D
//   160 the 20 chunks take a whole warp, 12 lanes idle); no per-element
//   divide.  Each block writes
//   an unnormalised float32 partial (o, m, l) to scratch that the
//   wrapper allocates; the combine kernel rescales the splits by
//   exp(m_s - max m), sums, divides by the floored l and casts.  A split
//   with no visible key has m = -1e30, l = 0, o = 0 and contributes
//   nothing.
//
// The library is built with --fmad=false (as every kernel of the port);
// the dot products and updates that should be fused are written with
// fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;    // f32 route: query rows (warps) per block
constexpr int kTile = 32;   // f32 route: keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ------------------------------------------------------------ route f32
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

// ------------------------------------------------ bf16 helpers (tc, split)
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// D[16x8] += A[16x16] B[16x8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x by the SFU's approximation (about 2 ulp; results below 2^-126
// flush to zero).  IEEE exp2f costs several instructions more, and the
// exponentials are the tensor-core route's critical path.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// ------------------------------------------------------------- route tc
constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;   // query rows per block
constexpr int kTcKeys = 64;              // keys per K/V tile
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
struct TcShape {
  static constexpr int kStages = 2;                 // K/V ring depth
  // blocks per SM to plan registers for (at D <= 64: 128 registers, no
  // spills; 4 blocks of 4 warps per SM measured fastest)
  static constexpr int kMinBlocks = D <= 64 ? 4 : 1;
  static constexpr int kTileElems = kTcKeys * D;
  static constexpr size_t kSmemBytes =
      (kTcRows * D + 2 * kStages * kTileElems) * sizeof(bf16);
};

// Element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled within each 128-byte line, so the 8 rows that
// one ldmatrix phase reads fall on 8 distinct bank groups.  A row longer
// than 128 bytes that is not a whole number of lines (D 160: 20 chunks,
// two lines and a tail of 4) swizzles its whole lines by row & 7 and its
// tail within itself by row & (tail - 1): an XOR over the whole row would
// move tail chunks 16-19 to 16-23, into the next row.  The tail's rows
// lie 320 bytes (a bank-group shift of 4) apart, so its reads are at most
// 2-way conflicted.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kChunks = D / 8;
  if constexpr (kChunks > 8 && kChunks % 8 != 0) {
    constexpr int kFull = kChunks / 8 * 8;
    constexpr int kTail = kChunks - kFull;
    static_assert((kTail & (kTail - 1)) == 0,
                  "the tail of a row must be a power of two chunks");
    const int c = chunk < kFull ? chunk ^ (row & 7)
                                : kFull + ((chunk - kFull) ^ (row & (kTail - 1)));
    return row * D + (c << 3);
  } else {
    constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
    constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
    return row * D + ((chunk ^ ((row / kRowsPerLine) & kMask)) << 3);
  }
}

// Copy rows [0, kRowsT) of a strided [rows, D] matrix (row stride rs
// elements) into a swizzled tile; rows >= n_valid are zero-filled.
template <int D, int kRowsT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int n_valid) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = kRowsT * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kTcThreads - 1) / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    if (kTotal % kTcThreads != 0 && idx >= kTotal) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < n_valid;
    cp_async16(dst + swz<D>(r, c), ok ? src + r * rs + c * 8 : src, ok);
  }
}

// grid (ceil(Sq / 64), B * Hq), 128 threads, TcShape<D>::kSmemBytes of
// dynamic shared memory: Q [64][D], then K [kStages][64][D], then V.
template <int D>
__global__ void __launch_bounds__(kTcThreads, TcShape<D>::kMinBlocks)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                Strides qs, Strides ks, Strides vs, Strides os, int Hq,
                int Hkv, int Sq, int kv_len, int causal, int window,
                float scale_log2) {
  constexpr int kS = TcShape<D>::kStages;
  constexpr int kTileElems = TcShape<D>::kTileElems;
  constexpr int kKSteps = D / 16;      // k-steps of Q K^T
  constexpr int kOutTiles = D / 8;     // 8-wide n-tiles of O
  constexpr int kKeyTiles = kTcKeys / 8;   // 8-key n-tiles of S
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* k_s = q_s + kTcRows * D;
  bf16* v_s = k_s + kS * kTileElems;

  const int row_tile = gridDim.x - 1 - blockIdx.x;   // last rows first
  const int b = blockIdx.y / Hq;
  const int hq = blockIdx.y % Hq;
  const int hk = hq / (Hq / Hkv);
  const int r0 = row_tile * kTcRows;
  const int off = kv_len - Sq;                       // position of query 0
  const int pos_lo = r0 + off;
  const int pos_hi = min(r0 + kTcRows, Sq) - 1 + off;
  const int k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int k_hi = causal ? min(kv_len - 1, pos_hi) : kv_len - 1;
  const int t_first = k_lo / kTcKeys;
  const int n_tiles = k_hi / kTcKeys - t_first + 1;

  const bf16* qb = q + b * qs.b + hq * qs.h + r0 * qs.s;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // prologue: Q and the first kS - 1 tiles, one commit group per tile
  // (Q rides in the first)
  load_tile<D, kTcRows>(q_s, qb, qs.s, Sq - r0);
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = (t_first + s) * kTcKeys;
      load_tile<D, kTcKeys>(k_s + s * kTileElems, kb + t0 * ks.s, ks.s,
                            kv_len - t0);
      load_tile<D, kTcKeys>(v_s + s * kTileElems, vb + t0 * vs.s, vs.s,
                            kv_len - t0);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int tq = lane & 3;          // fragment column pair
  const int qp_a = pos_lo + warp * 16 + g;   // positions of this thread's
  const int qp_b = qp_a + 8;                 // two rows
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float oacc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  uint32_t qa[kQInRegs ? kKSteps : 1][4];
  // ldmatrix addressing (see the fragment layouts of m16n8k16):
  // A (Q): lanes 0-15 give rows 0-15 of the low 8 columns, 16-31 the high
  const int a_row = warp * 16 + (lane & 15);
  const int a_chunk = lane >> 4;
  // B of Q K^T (K rows, not transposed): two n-tiles of 8 keys x 16 dims
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_chunk = (lane >> 3) & 1;
  // B of P V (V rows, transposed): 16 keys x two n-tiles of 8 dims
  const int vb_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vb_chunk = lane >> 4;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kS - 2>();   // tile `it` (and Q) has landed
    __syncthreads();           // ... for every thread; stage of it-1 free
    {
      const int nt = it + kS - 1;
      if (nt < n_tiles) {
        const int st = nt % kS;
        const int t0 = (t_first + nt) * kTcKeys;
        load_tile<D, kTcKeys>(k_s + st * kTileElems, kb + t0 * ks.s, ks.s,
                              kv_len - t0);
        load_tile<D, kTcKeys>(v_s + st * kTileElems, vb + t0 * vs.s, vs.s,
                              kv_len - t0);
      }
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < kKSteps; ++kc)
          ldmatrix_x4(qa[kc], q_s + swz<D>(a_row, 2 * kc + a_chunk));
      }
    }
    const bf16* kt = k_s + (it % kS) * kTileElems;
    const bf16* vt = v_s + (it % kS) * kTileElems;
    const int t0 = (t_first + it) * kTcKeys;

    // S = Q K^T: 16 rows x kTcKeys keys per warp, 8-key n-tiles
    float sacc[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKSteps; ++kc) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kc][i];
      } else {
        ldmatrix_x4(a, q_s + swz<D>(a_row, 2 * kc + a_chunk));
      }
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + swz<D>(np * 16 + kb_row, 2 * kc + kb_chunk));
        mma_bf16(sacc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scores in the base-2 domain; the mask only where a tile crosses the
    // diagonal, the window's edge or kv_len
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] *= scale_log2;
    const bool full = t0 + kTcKeys - 1 < kv_len &&
                      (!causal || t0 + kTcKeys - 1 <= pos_lo) &&
                      (window <= 0 || t0 > pos_hi - window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * tq + (e & 1);
          const int qp = e < 2 ? qp_a : qp_b;
          bool vis = key < kv_len;
          if (causal) vis = vis && key <= qp;
          if (window > 0) vis = vis && key > qp - window;
          if (!vis) sacc[j][e] = kNegInf;
        }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sacc[j][0], sacc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sacc[j][2], sacc[j][3]));
    }
#pragma unroll
    for (int off2 = 1; off2 < 4; off2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off2));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2_approx(m_a - mn_a);
    const float alpha_b = exp2_approx(m_b - mn_b);
    // a row with no visible key so far keeps p = 0 (once it has one,
    // 2^(-1e30 - m) is 0)
    const bool dead_a = mn_a == kNegInf, dead_b = mn_b == kNegInf;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      sacc[j][0] = dead_a ? 0.f : exp2_approx(sacc[j][0] - mn_a);
      sacc[j][1] = dead_a ? 0.f : exp2_approx(sacc[j][1] - mn_a);
      sacc[j][2] = dead_b ? 0.f : exp2_approx(sacc[j][2] - mn_b);
      sacc[j][3] = dead_b ? 0.f : exp2_approx(sacc[j][3] - mn_b);
      rs_a += sacc[j][0] + sacc[j][1];
      rs_b += sacc[j][2] + sacc[j][3];
    }
    l_a = fmaf(l_a, alpha_a, rs_a);   // per-thread partial row sums
    l_b = fmaf(l_b, alpha_b, rs_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      oacc[n][0] *= alpha_a;
      oacc[n][1] *= alpha_a;
      oacc[n][2] *= alpha_b;
      oacc[n][3] *= alpha_b;
    }

    // O += P V: P (bf16) from the score fragments, V by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kTcKeys / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]),
          pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]),
          pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]),
          pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kOutTiles / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + swz<D>(kc * 16 + vb_row,
                                          2 * dp + vb_chunk));
        mma_bf16(oacc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: full row sums over the quad, floor, divide, cast, store
#pragma unroll
  for (int off2 = 1; off2 < 4; off2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off2);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const int row_a = r0 + warp * 16 + g;
  bf16* ob = o + b * os.b + hq * os.h + 2 * tq;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * os.s + 8 * n) =
          __floats2bfloat162_rn(oacc[n][0] / den_a, oacc[n][1] / den_a);
    if (row_a + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row_a + 8) * os.s + 8 * n) =
          __floats2bfloat162_rn(oacc[n][2] / den_b, oacc[n][3] / den_b);
  }
}

// ---------------------------------------------------------- route split
__host__ __device__ constexpr int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitHeads = 8;    // query heads of one kv head per block
constexpr int kSplitUnroll = 4;   // keys in flight per lane

// grid (splits, B * Hkv, ceil(group / kSplitHeads)), 128 threads.  Split
// s covers keys [lo + s * per, min(lo + (s + 1) * per, kv_len)), all of
// them visible to the one query at position kv_len - 1 (the host plans
// the ranges over the visible range).  Writes o_part [splits, B, Hq, D]
// (unnormalised), m_part and l_part [splits, B, Hq], float32.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   Strides qs, Strides ks, Strides vs, int B, int Hq,
                   int Hkv, int kv_len, int lo, int per, float scale) {
  // lanes per key, 16 B each: D / 8 rounded up to a power of two, so the
  // keys of a warp step tile the 32 lanes (D 160: 20 chunks on 32 lanes,
  // one key per warp step, lanes 20-31 hold zeros and load nothing)
  constexpr int kChunks = D / 8;
  constexpr int kLpk = pow2_ceil(kChunks);
  static_assert(kLpk <= 32, "a key must fit one warp");
  constexpr int kKpw = 32 / kLpk;          // keys per warp step
  constexpr int kSlots = kSplitWarps * kKpw;
  __shared__ float red[kSplitWarps][kSplitHeads][D + 2];

  const int split = blockIdx.x;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = Hq / Hkv;
  const int h0 = hk * group + blockIdx.z * kSplitHeads;
  const int nh = min(kSplitHeads, group - blockIdx.z * kSplitHeads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % kLpk;               // dims 8c .. 8c + 7
  const bool c_ok = kChunks == kLpk || c < kChunks;
  const int slot = warp * kKpw + lane / kLpk;
  const int k_begin = lo + split * per;
  const int k_end = min(k_begin + per, kv_len);

  float qf[kSplitHeads][8];
#pragma unroll
  for (int h = 0; h < kSplitHeads; ++h) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (h < nh && c_ok)
      raw = __ldg(reinterpret_cast<const uint4*>(
          q + b * qs.b + (h0 + h) * qs.h + c * 8));
    unpack8(raw, qf[h]);
  }
  float m[kSplitHeads], l[kSplitHeads], acc[kSplitHeads][8];
#pragma unroll
  for (int h = 0; h < kSplitHeads; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[h][i] = 0.f;
  }

  const bf16* kb = k + b * ks.b + hk * ks.h + c * 8;
  const bf16* vb = v + b * vs.b + hk * vs.h + c * 8;
  // the trip count is block-uniform, so every lane reaches the shuffles
  for (int base = k_begin; base < k_end; base += kSlots * kSplitUnroll) {
    uint4 kr[kSplitUnroll], vr[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int key = base + u * kSlots + slot;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (key < k_end && c_ok) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + key * ks.s));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + key * vs.s));
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const bool valid = base + u * kSlots + slot < k_end;
      float kf[8], vf[8];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int h = 0; h < kSplitHeads; ++h) {
        if (h >= nh) break;                // block-uniform
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qf[h][i], kf[i], s);
#pragma unroll
        for (int off2 = 1; off2 < kLpk; off2 <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off2);
        if (!valid) continue;
        s *= scale;
        const float m_new = fmaxf(m[h], s);
        const float alpha = expf(m[h] - m_new);
        const float p = expf(s - m_new);
        l[h] = fmaf(l[h], alpha, p);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[h][i] = fmaf(p, vf[i], acc[h][i] * alpha);
        m[h] = m_new;
      }
    }
  }

  // merge the key slots of a warp (lanes kLpk, 2 kLpk, ... apart)
#pragma unroll
  for (int off2 = kLpk; off2 < 32; off2 <<= 1) {
#pragma unroll
    for (int h = 0; h < kSplitHeads; ++h) {
      if (h >= nh) break;
      const float m_o = __shfl_xor_sync(0xffffffffu, m[h], off2);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[h], off2);
      const float m_new = fmaxf(m[h], m_o);
      const float a = expf(m[h] - m_new), bo = expf(m_o - m_new);
      l[h] = fmaf(l[h], a, l_o * bo);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[h][i], off2);
        acc[h][i] = fmaf(acc[h][i], a, acc_o * bo);
      }
      m[h] = m_new;
    }
  }
  if (lane < kLpk && c_ok) {
#pragma unroll
    for (int h = 0; h < kSplitHeads; ++h) {
      if (h >= nh) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp][h][c * 8 + i] = acc[h][i];
      if (c == 0) {
        red[warp][h][D] = m[h];
        red[warp][h][D + 1] = l[h];
      }
    }
  }
  __syncthreads();
  // merge the warps and write this split's partial
  for (int idx = threadIdx.x; idx < nh * D; idx += kSplitThreads) {
    const int h = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, red[w][h][D]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float a = expf(red[w][h][D] - mx);
      lsum = fmaf(red[w][h][D + 1], a, lsum);
      osum = fmaf(red[w][h][d], a, osum);
    }
    const long long row =
        (static_cast<long long>(split) * B + b) * Hq + h0 + h;
    o_part[row * D + d] = osum;
    if (d == 0) {
      m_part[row] = mx;
      l_part[row] = lsum;
    }
  }
}

// grid B * Hq (one block per query row), max(D, 32) threads.
__global__ void flash_combine_kernel(const float* __restrict__ o_part,
                                     const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     bf16* __restrict__ o, long long o_b,
                                     long long o_h, int splits, int B,
                                     int Hq, int D) {
  const int row = blockIdx.x;
  const int b = row / Hq, hq = row % Hq;
  const long long rows = static_cast<long long>(B) * Hq;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[s * rows + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(m_part[s * rows + row] - mx);
      lsum = fmaf(w, l_part[s * rows + row], lsum);
      osum = fmaf(w, o_part[(s * rows + row) * D + d], osum);
    }
    o[b * o_b + hq * o_h + d] =
        __float2bfloat16_rn(osum / fmaxf(lsum, 1e-30f));
  }
}

// ------------------------------------------------------------- launches
template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, void* o,
                 const long long* st, int B, int Hq, int Hkv, int Sq,
                 int Skv, int kv_len, int causal, int window, float scale,
                 cudaStream_t stream) {
  const size_t smem = (2 * kTile * (D + 1) + kRows * D) * sizeof(float);
  auto kern = flash_kernel<float, D>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      Hq, Hkv, Sq, Skv, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc_d(const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int Hq, int Hkv, int Sq,
                int kv_len, int causal, int window, float scale,
                cudaStream_t stream) {
  const size_t smem = TcShape<D>::kSmemBytes;
  auto kern = flash_tc_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + kTcRows - 1) / kTcRows, B * Hq);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os,
      Hq, Hkv, Sq, kv_len, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_split_d(const void* q, const void* k, const void* v,
                   const long long* st, float* parts, int B, int Hq,
                   int Hkv, int kv_len, int lo, int per, int splits,
                   float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  const long long rows = static_cast<long long>(splits) * B * Hq;
  const int group = Hq / Hkv;
  dim3 grid(splits, B * Hkv, (group + kSplitHeads - 1) / kSplitHeads);
  flash_split_kernel<D><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), parts, parts + rows * D,
      parts + rows * D + rows, qs, ks, vs, B, Hq, Hkv, kv_len, lo, per,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_combine(const float* parts, void* o, long long o_b,
                   long long o_h, int splits, int B, int Hq, int D,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(splits) * B * Hq;
  flash_combine_kernel<<<B * Hq, D < 32 ? 32 : D, 0, stream>>>(
      parts, parts + rows * D, parts + rows * D + rows,
      static_cast<bf16*>(o), o_b, o_h, splits, B, Hq, D);
  return static_cast<int>(cudaGetLastError());
}

// a non-causal call may have Sq > kv_len: its queries sit at negative
// positions, which only a window (absent from cross-attention) would read
bool bad_shape(int B, int Hq, int Hkv, int Sq, int Skv, int kv_len,
               int causal) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Hq % Hkv != 0 ||
         kv_len <= 0 || kv_len > Skv || (causal && Sq > kv_len);
}

}  // namespace

#define FA_DISPATCH_D(D, CALL)                         \
  switch (D) {                                         \
    case 16: { constexpr int kD = 16; return CALL; }   \
    case 32: { constexpr int kD = 32; return CALL; }   \
    case 64: { constexpr int kD = 64; return CALL; }   \
    case 128: { constexpr int kD = 128; return CALL; } \
    case 160: { constexpr int kD = 160; return CALL; } \
    case 256: { constexpr int kD = 256; return CALL; } \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Plain C entry points, loaded with ctypes.  strides: 12 element strides,
// the (b, h, s) strides of q, k, v and o in that order; the head dim is
// contiguous.  Each launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The caller
// guarantees B, Hq, Hkv, Sq > 0, Hq % Hkv == 0, 0 < kv_len <= Skv and,
// when causal, Sq <= kv_len; the bf16 routes also need 16-byte aligned
// q/k/v rows (data pointers 16-byte aligned, strides multiples of 8
// elements).

// Route f32: float32 q, k, v, o.
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Skv,
    int D, int kv_len, int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, kv_len, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH_D(D, launch_f32_d<kD>(q, k, v, o, strides, B, Hq, Hkv, Sq,
                                    Skv, kv_len, causal, window, scale, s))
}

// Route tc: bfloat16 q, k, v, o; the tensor-core kernel (any Sq).
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Skv,
    int D, int kv_len, int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, kv_len, causal) ||
      static_cast<long long>(B) * Hq > 65535)   // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH_D(D, launch_tc_d<kD>(q, k, v, o, strides, B, Hq, Hkv, Sq,
                                   kv_len, causal, window, scale, s))
}

// Route split: bfloat16 q [B, Hq, 1, D], k, v; the partial kernel over
// `splits` key ranges [lo + s per, min(lo + (s + 1) per, kv_len)), then,
// when o is not null, the combine kernel into o [B, Hq, 1, D].  parts:
// float32 scratch of splits * B * Hq * (D + 2) elements, laid out as
// o_part [splits, B, Hq, D], m_part [splits, B, Hq], l_part likewise.
extern "C" int flash_attention_split_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, float* parts, int B, int Hq, int Hkv,
    int Skv, int D, int kv_len, int lo, int per, int splits, float scale,
    void* stream) {
  if (bad_shape(B, Hq, Hkv, 1, Skv, kv_len, 1) || splits <= 0 || per <= 0 ||
      lo < 0 || lo + static_cast<long long>(splits - 1) * per >= kv_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (D) {
    case 16: err = launch_split_d<16>(q, k, v, strides, parts, B, Hq, Hkv,
                                      kv_len, lo, per, splits, scale, s);
      break;
    case 32: err = launch_split_d<32>(q, k, v, strides, parts, B, Hq, Hkv,
                                      kv_len, lo, per, splits, scale, s);
      break;
    case 64: err = launch_split_d<64>(q, k, v, strides, parts, B, Hq, Hkv,
                                      kv_len, lo, per, splits, scale, s);
      break;
    case 128: err = launch_split_d<128>(q, k, v, strides, parts, B, Hq,
                                        Hkv, kv_len, lo, per, splits, scale,
                                        s);
      break;
    case 160: err = launch_split_d<160>(q, k, v, strides, parts, B, Hq,
                                        Hkv, kv_len, lo, per, splits, scale,
                                        s);
      break;
    case 256: err = launch_split_d<256>(q, k, v, strides, parts, B, Hq,
                                        Hkv, kv_len, lo, per, splits, scale,
                                        s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || o == nullptr) return err;
  return launch_combine(parts, o, strides[9], strides[10], splits, B, Hq, D,
                        s);
}

// The combine kernel alone (the second half of route split): parts as
// above, o bfloat16 with (b, h) strides o_b, o_h and a contiguous head
// dim.
extern "C" int flash_attention_combine_launch(const float* parts, void* o,
                                              long long o_b, long long o_h,
                                              int splits, int B, int Hq,
                                              int D, void* stream) {
  if (splits <= 0 || B <= 0 || Hq <= 0 || D <= 0 || D > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_combine(parts, o, o_b, o_h, splits, B, Hq, D,
                        static_cast<cudaStream_t>(stream));
}
