// Mamba-2 SSD chunked scan, for Hopper (sm_90a): three chunk-parallel
// kernels.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_kernel (Pallas;
// wrapper ssd_scan).  On the TPU the chunk axis was the sequential grid
// dimension and the state [N, P] sat in VMEM scratch between grid steps.
// Here the scan is cut into the three phases of the Mamba-2 paper's SSD
// algorithm (Dao & Gu 2024, arXiv:2405.21060, §6), so that every chunk
// of every head is a block of its own and only the elementwise pass over
// the states runs in chunk order:
//
//   ssd_chunk_state  grid (nc, Bt, head groups): per chunk c and head h
//       cum   = inclusive prefix sum of dt * A (a warp scan),
//       S_c   = (B ⊙ exp(total - cum))ᵀ (dt x)          -> S_loc [Bt,nc,H,N,P]
//       total = cum[Q-1]                                -> total [Bt,nc,H]
//   ssd_state_pass   grid (tiles of N·P, Bt·H): in chunk order
//       h_in[c] = h;  h = exp(total_c) h + S_c          (h_in overwrites
//       S_loc in place: each element is read before it is written), and
//       after the last chunk the final state, which prefill hands to
//       decode (the reference obtains it by a sequential scan over L);
//   ssd_chunk_scan   grid (nc, Bt, head groups): per block C Bᵀ [Q, Q]
//       once, then for each head of the group
//       G = C Bᵀ ⊙ Γ ⊙ dt_j,  Γ[i][j] = exp(cum_i - cum_j) where j <= i,
//           else 0 (a select, as the Pallas kernel has it: above the
//           diagonal the exp may overflow, and inf * 0 would be NaN),
//       y = G x + exp(cum) ⊙ (C h_in) + D x, written once.
//
// What bounds it on the H100: bytes.  The function reads x, dt, B, C
// once and writes y and the final state once: at Hymba's prefill shape
// (Bt 4, L 1536, H 50, P 64, N 16, Q 64) about 160 MB, 0.0478 ms at
// 3.35 TB/s, against about 3 GFLOP of float32 work (0.043 ms at 67
// TFLOP/s).  The three phases move about 315 MB: x is read twice
// (2 × 78.6 MB), y written once (78.6 MB), and S_loc is written, read
// and rewritten as h_in, then read again (4 × 19.7 MB, of which about
// 79 MB can hit the 50 MB L2, since each phase follows the one that
// wrote them).  What the design does about it:
//   * every block is one (batch, chunk, head group): 960 blocks of
//     chunk_scan at Hymba's shape against the 200 of a block per
//     (batch, head) walking 24 chunks;
//   * no product reads both operands from shared memory per
//     multiply-add: chunk_state's S [N, P] and C Bᵀ are float32 FFMA on
//     4 x 4 register tiles (float4 operands, 16 FMAs per two loads);
//     y's two products, G x and C h_in, run on the tensor cores as
//     3xTF32 mma.sync (see split_tf32), a warp owning 16 rows by 32
//     columns of y;
//   * C Bᵀ is formed once per block and reused by every head of the
//     group (B and C are one group, shared by all heads);
//   * x, h_in, B, C and dt arrive by cp.async; in chunk_scan the next
//     head's x and h_in stream into a second buffer, and its G is
//     formed into a second buffer, while this head's products run (one
//     barrier per head);
//   * the cumulative decay is a warp scan (__shfl_up_sync), one warp per
//     head.
// Accumulation is float32 throughout (explicit fmaf: the port builds
// with --fmad=false), so the scan keeps its 1e-4 agreement with the
// plain versions.  Shapes: 0 < Q <= 64, L % Q == 0, any P and N that
// shared memory holds (N = 128 at P = 64 takes 221 KB in chunk_scan);
// Q, N and P off the tile are padded in shared memory (zero along the
// products' k) and masked on store, and 4-byte copies stand in for
// 16-byte ones where rows are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr int kStateThreads = 128;   // ssd_chunk_state
constexpr int kPassThreads = 128;    // ssd_state_pass
constexpr int kScanThreads = 256;    // ssd_chunk_scan
// a warp's unit of the tensor-core products: 16 rows by kNT n tiles of 8
// columns
constexpr int kNT = 4;
constexpr int kPassBatch = 8;        // chunks loaded ahead in the pass
constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies `rows` rows of `cols` floats (global row stride `gs`) into
// shared rows of stride `ss`: 16-byte copies when `vec` (cols % 4 == 0,
// rows 16-byte aligned in both), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, int ss,
                                           const float* src, long long gs,
                                           int rows, int cols, bool vec) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int idx = threadIdx.x; idx < rows * c4; idx += blockDim.x) {
      const int r = idx / c4, c = idx - r * c4;
      cp_async16(dst + r * ss + 4 * c, src + r * gs + 4 * c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = idx - r * cols;
      cp_async4(dst + r * ss + c, src + r * gs + c);
    }
  }
}

// Stores 4 consecutive outputs at dst[0..3], the first `n` of them
// (n < 4 only at a ragged edge, where `vec` is false).
__device__ __forceinline__ void store4(float* dst, float4 v, int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    if (n > 0) dst[0] = v.x;
    if (n > 1) dst[1] = v.y;
    if (n > 2) dst[2] = v.z;
    if (n > 3) dst[3] = v.w;
  }
}

// Inclusive prefix sum of dt[t] * a over t < Q (Q <= 64) by one warp,
// two steps per lane; writes cum[0..Q) and returns the total to every
// lane.
__device__ __forceinline__ float warp_cumsum(const float* dt, float a,
                                             int Q, float* cum) {
  const int lane = threadIdx.x & 31;
  const int t0 = 2 * lane, t1 = t0 + 1;
  const float d0 = t0 < Q ? dt[t0] * a : 0.f;
  const float d1 = t1 < Q ? dt[t1] * a : 0.f;
  float s = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + d0;
  if (t0 < Q) cum[t0] = c0;
  if (t1 < Q) cum[t1] = c0 + d1;
  return __shfl_sync(0xffffffffu, s, 31);
}

// The products run on the tensor cores as 3xTF32: each operand is
// split into hi = tf32(a) and lo = a - hi, and a·b is taken as
// lo·hi + hi·lo + hi·hi (mma.sync.m16n8k8, float32 accumulators), which
// keeps float32's accuracy; the dropped lo·lo term is below its
// rounding.  hi is rounded to tf32 with integer operations (add half a
// tf32 unit, clear the 13 low bits), not cvt.rna.tf32.f32, which issues
// at the conversion rate; the tensor cores read lo's top 19 bits and
// drop the rest, which costs lo, and so a·b, about 2^-21 relative.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A[r0:r0+16, 0:kend] B[0:kend, c0+8nn : c0+8nn+8], nn < NT, by one warp
// (kend % 8 == 0): the hi·hi products into acc[nn], the two small
// lo·hi + hi·lo products into low[nn] (two short chains in place of one
// of three; the caller adds low to acc last).  A[r][k] is a[r * lda + k],
// or a[k * lda + r] when kAT (stored transposed), times ascale[k] when
// kScale; B[k][c] is b[k * ldb + c].
template <bool kAT, int NT, bool kScale = false>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         float (&low)[NT][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int r0, int c0, int kend,
                                         const float* ascale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kend; k += 8) {
    float av[4];
    if (kAT) {
      av[0] = a[(k + t) * lda + r0 + g];
      av[1] = a[(k + t) * lda + r0 + g + 8];
      av[2] = a[(k + t + 4) * lda + r0 + g];
      av[3] = a[(k + t + 4) * lda + r0 + g + 8];
    } else {
      av[0] = a[(r0 + g) * lda + k + t];
      av[1] = a[(r0 + g + 8) * lda + k + t];
      av[2] = a[(r0 + g) * lda + k + t + 4];
      av[3] = a[(r0 + g + 8) * lda + k + t + 4];
    }
    if (kScale) {
      const float s0 = ascale[k + t], s1 = ascale[k + t + 4];
      av[0] *= s0;
      av[1] *= s0;
      av[2] *= s1;
      av[3] *= s1;
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(av[q], ah[q], al[q]);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const float* bc = b + c0 + 8 * nn + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bc[(k + t) * ldb], bh0, bl0);
      split_tf32(bc[(k + t + 4) * ldb], bh1, bl1);
      mma_tf32(low[nn], al, bh0, bh1);
      mma_tf32(low[nn], ah, bl0, bl1);
      mma_tf32(acc[nn], ah, bh0, bh1);
    }
  }
}

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// ---------------------------------------------------------------- phase 1
// S [N, P] = (B ⊙ coef)ᵀ x per head, coef = dt * exp(total - cum), on
// the tensor cores: A[n][j] = B[j][n] coef[j] is read from B's own
// layout (transposed), and a warp owns 16 rows of S by 8 kNT
// columns.  Shared memory (float32), Q8 = round8(Q), N16 = round16(N),
// Pw = P rounded up to 8 kNT:
//   B [Q8][lb], lb = round32(N16) + 8;  x [HG][Q8][lx], lx = Pw + 8
//     (strides that put a fragment load's 32 lanes on 32 banks);
//   dt, coef [HG][Q8].
// The k padding (rows Q..Q8 of B and x, coef) is zero.
struct StateSmem {
  int Q8, N16, Pw, lb, lx;
  size_t b, x, dt, coef, total;
  __host__ __device__ StateSmem(int Q, int P, int N, int HG) {
    Q8 = round8(Q);
    N16 = round16(N);
    Pw = (P + 8 * kNT - 1) / (8 * kNT) * (8 * kNT);
    lb = (N16 + 31) / 32 * 32 + 8;
    lx = Pw + 8;
    b = 0;
    x = b + static_cast<size_t>(Q8) * lb;
    dt = x + static_cast<size_t>(HG) * Q8 * lx;
    coef = dt + static_cast<size_t>(HG) * Q8;
    total = coef + static_cast<size_t>(HG) * Q8;
  }
};

__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ S_loc, float* __restrict__ total,
                int L, int H, int P, int N, int Q, int HG, int vec_x,
                int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const StateSmem lay(Q, P, N, HG);
  const int Q8 = lay.Q8, lb = lay.lb, lx = lay.lx;
  float* b_s = smem + lay.b;
  float* x_s = smem + lay.x;
  float* dt_s = smem + lay.dt;
  float* coef_s = smem + lay.coef;

  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int nh = min(HG, H - h0);
  const int nc = L / Q;
  const long long row0 = static_cast<long long>(b) * L + c * Q;

  for (int idx = threadIdx.x; idx < (Q8 - Q) * lb; idx += blockDim.x)
    b_s[Q * lb + idx] = 0.f;
  for (int hl = 0; hl < nh; ++hl)
    for (int idx = threadIdx.x; idx < (Q8 - Q) * lx; idx += blockDim.x)
      x_s[(hl * Q8 + Q) * lx + idx] = 0.f;
  stage_rows(b_s, lb, Bm + row0 * N, N, Q, N, vec_b != 0);
  // x rows of the group are contiguous: nh * P floats per step
  for (int hl = 0; hl < nh; ++hl)
    stage_rows(x_s + hl * Q8 * lx, lx, x + (row0 * H + h0 + hl) * P,
               static_cast<long long>(H) * P, Q, P, vec_x != 0);
  for (int idx = threadIdx.x; idx < nh * Q; idx += blockDim.x) {
    const int hl = idx / Q, t = idx - hl * Q;
    cp_async4(dt_s + hl * Q8 + t, dt + (row0 + t) * H + h0 + hl);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int hl = warp; hl < nh; hl += nwarps) {
    float* cum = coef_s + hl * Q8;      // cum first, then the coefficient
    const float tot = warp_cumsum(dt_s + hl * Q8, A[h0 + hl], Q, cum);
    __syncwarp();
    for (int t = lane; t < Q8; t += 32)
      cum[t] = t < Q ? dt_s[hl * Q8 + t] * expf(tot - cum[t]) : 0.f;
    if (lane == 0)
      total[(static_cast<long long>(b) * nc + c) * H + h0 + hl] = tot;
  }
  __syncthreads();

  // warp units: (head, 16-row tile of S, 8 kNT columns)
  constexpr int kCols = 8 * kNT;
  const int MT = lay.N16 >> 4;
  const int per_head = MT * (lay.Pw / kCols);
  const int gq = lane >> 2, tq = lane & 3;
  const bool vs = (P & 3) == 0;
  for (int u = warp; u < nh * per_head; u += nwarps) {
    const int hl = u / per_head, r = u - hl * per_head;
    const int r0 = (r % MT) * 16, c0 = (r / MT) * kCols;
    float acc[kNT][4] = {}, low[kNT][4] = {};
    mma_rows<true, kNT, true>(acc, low, b_s, lb, x_s + hl * Q8 * lx, lx,
                                  r0, c0, Q8, coef_s + hl * Q8);
    float* out = S_loc + ((static_cast<long long>(b) * nc + c) * H + h0 +
                          hl) * N * P;
#pragma unroll
    for (int nn = 0; nn < kNT; ++nn) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = r0 + gq + 8 * hr;
        const int p = c0 + 8 * nn + 2 * tq;
        if (n >= N || p >= P) continue;
        const float o0 = acc[nn][2 * hr] + low[nn][2 * hr];
        const float o1 = acc[nn][2 * hr + 1] + low[nn][2 * hr + 1];
        float* dst = out + n * P + p;
        if (vs) {
          *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
        } else {
          dst[0] = o0;
          if (p + 1 < P) dst[1] = o1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- phase 2
// One thread per 4 consecutive elements of a (batch, head)'s N·P state.
// h_in may be S_loc itself (in place): every chunk's S is loaded before
// the h_in of that chunk is stored.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* S_loc, const float* __restrict__ total,
               float* h_in, float* __restrict__ state_out, int nc, int H,
               int NP) {
  const int bh = blockIdx.y;
  const int b = bh / H, hd = bh - b * H;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e0 >= NP) return;
  const int n = min(4, NP - e0);
  const bool vec = (NP & 3) == 0;
  const long long stride = static_cast<long long>(H) * NP;  // one chunk
  const long long base = (static_cast<long long>(b) * nc * H + hd) * NP + e0;
  const float* tot = total + static_cast<long long>(b) * nc * H + hd;
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float s[kPassBatch][4], e[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k >= nc) continue;
      const float* src = S_loc + base + (c0 + k) * stride;
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[k][0] = v.x; s[k][1] = v.y; s[k][2] = v.z; s[k][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[k][i] = i < n ? src[i] : 0.f;
      }
      e[k] = expf(tot[(c0 + k) * H]);
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k >= nc) continue;
      store4(h_in + base + (c0 + k) * stride,
             make_float4(h[0], h[1], h[2], h[3]), n, vec);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = fmaf(e[k], h[i], s[k][i]);
    }
  }
  if (state_out != nullptr)
    store4(state_out + static_cast<long long>(bh) * NP + e0,
           make_float4(h[0], h[1], h[2], h[3]), n, vec);
}

// ---------------------------------------------------------------- phase 3
// Shared memory (float32), Qp = round4(Q), Q8/Q16 = Q rounded up to 8/16,
// N8 = round8(N), Pw = P rounded up to a warp unit's 8 kNT columns:
//   Ct [N8][lt], lt = Q16 + 8 (C transposed: 4 steps are one float4 for
//     C Bᵀ, and Ct is the A operand of C h_in);
//   Bt [N][lt] (B transposed), which is dead once C Bᵀ is formed, and
//     shares its space with G1;
//   CB [Qp][Qp] = C Bᵀ (row-major, so that G's rows read it along j);
//   G0, G1 [Q16][lg], lg = Q8 + 4: G ⊙ dt_j of heads 0, 2, 4 ... and
//     1, 3, 5 ... (row-major: the A operand of G x), so that one head's
//     G is formed while the products of the head before it run;
//   dt, cum, ecum [HG][Qp];
//   two buffers of x [Q8][lx] and h_in [N8][lx], lx = Pw + 8.
// The row strides put the 32 lanes of a fragment load on 32 banks.  The
// k padding (rows Q..Q8 of x, N..N8 of Ct and h_in, columns Q..Q8 of G)
// is zero; other padding only reaches outputs that are not stored.
struct ScanSmem {
  int Qp, Q8, Q16, N8, Pw, lt, lg, lx;
  size_t ct, bt, cb, g0, dt, cum, ecum, ring, stage, total;
  __host__ __device__ ScanSmem(int Q, int P, int N, int HG) {
    Qp = round4(Q);
    Q8 = round8(Q);
    Q16 = round16(Q);
    N8 = round8(N);
    Pw = (P + 8 * kNT - 1) / (8 * kNT) * (8 * kNT);
    lt = Q16 + 8;
    lg = Q8 + 4;
    lx = Pw + 8;
    ct = 0;
    bt = ct + static_cast<size_t>(N8) * lt;
    const size_t g_size = static_cast<size_t>(Q16) * lg;
    const size_t bt_size = static_cast<size_t>(N) * lt;
    cb = bt + (bt_size > g_size ? bt_size : g_size);
    g0 = cb + static_cast<size_t>(Qp) * Qp;
    dt = g0 + g_size;
    cum = dt + static_cast<size_t>(HG) * Qp;
    ecum = cum + static_cast<size_t>(HG) * Qp;
    ring = ecum + static_cast<size_t>(HG) * Qp;
    stage = static_cast<size_t>(Q8 + N8) * lx;
    total = ring + 2 * stage;
  }
};

__global__ void __launch_bounds__(kScanThreads, 2)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ h_in, float* __restrict__ y, int L,
               int H, int P, int N, int Q, int HG, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  const ScanSmem lay(Q, P, N, HG);
  const int Qp = lay.Qp, Q8 = lay.Q8, lt = lay.lt, lg = lay.lg, lx = lay.lx;
  float* ct_s = smem + lay.ct;
  float* bt_s = smem + lay.bt;
  float* cb_s = smem + lay.cb;
  float* const g_buf[2] = {smem + lay.g0, smem + lay.bt};
  float* dt_s = smem + lay.dt;
  float* cum_s = smem + lay.cum;
  float* ecum_s = smem + lay.ecum;
  float* ring = smem + lay.ring;

  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int nh = min(HG, H - h0);
  const int nc = L / Q;
  const long long row0 = static_cast<long long>(b) * L + c * Q;
  const bool vx = vec_x != 0;
  const bool vy = (P & 3) == 0;

  // this head's x [Q][P] and h_in [N][P] into buffer `st`
  auto stage_head = [&](int hl, int st) {
    float* xs = ring + st * lay.stage;
    stage_rows(xs, lx, x + (row0 * H + h0 + hl) * P,
               static_cast<long long>(H) * P, Q, P, vx);
    const float* hsrc = h_in + ((static_cast<long long>(b) * nc + c) * H +
                                h0 + hl) * N * P;
    stage_rows(xs + Q8 * lx, lx, hsrc, P, N, P, vx);
  };

  // the k padding, which no copy writes, is zero in both buffers
  for (int st = 0; st < 2; ++st) {
    float* xs = ring + st * lay.stage;
    for (int idx = threadIdx.x; idx < (Q8 - Q) * lx; idx += blockDim.x)
      xs[Q * lx + idx] = 0.f;
    for (int idx = threadIdx.x; idx < (lay.N8 - N) * lx; idx += blockDim.x)
      xs[(Q8 + N) * lx + idx] = 0.f;
  }
  for (int idx = threadIdx.x; idx < (lay.N8 - N) * lt; idx += blockDim.x)
    ct_s[N * lt + idx] = 0.f;
  for (int idx = threadIdx.x; idx < Q * N; idx += blockDim.x) {
    const int t = idx / N, n = idx - t * N;
    cp_async4(ct_s + n * lt + t, Cm + (row0 + t) * N + n);
    cp_async4(bt_s + n * lt + t, Bm + (row0 + t) * N + n);
  }
  for (int idx = threadIdx.x; idx < nh * Q; idx += blockDim.x) {
    const int hl = idx / Q, t = idx - hl * Q;
    cp_async4(dt_s + hl * Qp + t, dt + (row0 + t) * H + h0 + hl);
  }
  stage_head(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // cumulative decay of every head of the group, one warp per head
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int hl = warp; hl < nh; hl += nwarps) {
    float* cum = cum_s + hl * Qp;
    warp_cumsum(dt_s + hl * Qp, A[h0 + hl], Q, cum);
    __syncwarp();
    for (int t = threadIdx.x & 31; t < Q; t += 32)
      ecum_s[hl * Qp + t] = expf(cum[t]);
  }
  // C Bᵀ on the tiles at or below the diagonal, 4 x 4 per thread
  const int nt = Qp >> 2;
  for (int item = threadIdx.x; item < nt * nt; item += blockDim.x) {
    const int jt = item / nt, it = item - jt * nt;
    if (jt > it) continue;
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(ct_s + n * lt +
                                                         4 * it);
      const float4 bv = *reinterpret_cast<const float4*>(bt_s + n * lt +
                                                         4 * jt);
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][0] = fmaf(cv.x, bj[q], acc[q][0]);
        acc[q][1] = fmaf(cv.y, bj[q], acc[q][1]);
        acc[q][2] = fmaf(cv.z, bj[q], acc[q][2]);
        acc[q][3] = fmaf(cv.w, bj[q], acc[q][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(cb_s + (4 * it + k) * Qp + 4 * jt) =
          make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
  }

  // warp units: (16-row tile of y, 8 kNT columns)
  constexpr int kCols = 8 * kNT;
  const int MT = lay.Q16 >> 4;
  const int units = MT * (lay.Pw / kCols);
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  // G ⊙ dt_j of head hl into `g_s`, on the 16-row tiles up to their
  // diagonal, 4 columns per lane, a half warp per row; a select keeps
  // exp off j > i
  auto form_g = [&](int hl, float* g_s) {
    const float* cum = cum_s + hl * Qp;
    const float* dth = dt_s + hl * Qp;
    for (int i = 2 * warp + (lane >> 4); i < lay.Q16; i += 2 * nwarps) {
      const int j0 = (lane & 15) * 4;
      if (j0 >= min((i & ~15) + 16, Q8)) continue;
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < Q && j0 <= i) {
        const float4 cb4 = *reinterpret_cast<const float4*>(cb_s + i * Qp +
                                                            j0);
        const float4 cm4 = *reinterpret_cast<const float4*>(cum + j0);
        const float4 dt4 = *reinterpret_cast<const float4*>(dth + j0);
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        const float cmv[4] = {cm4.x, cm4.y, cm4.z, cm4.w};
        const float dtv[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
        const float ci = cum[i];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + k <= i) gv[k] = cbv[k] * expf(ci - cmv[k]) * dtv[k];
      }
      *reinterpret_cast<float4*>(g_s + i * lg + j0) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
  };
  __syncthreads();   // C Bᵀ and cum are complete; Bt is dead
  form_g(0, g_buf[0]);

  for (int hl = 0; hl < nh; ++hl) {
    const int st = hl & 1;
    cp_async_wait_all();
    // head hl's x, h_in and G are complete; every thread is done with
    // head hl - 1, whose buffers the next head takes
    __syncthreads();
    if (hl + 1 < nh) {
      stage_head(hl + 1, st ^ 1);
      cp_async_commit();
      form_g(hl + 1, g_buf[st ^ 1]);
    }
    const float* g_s = g_buf[st];
    const float* xs = ring + st * lay.stage;
    const float* hs = xs + Q8 * lx;
    const float dskip = Dv[h0 + hl];
    const float* ecum = ecum_s + hl * Qp;
    for (int u = warp; u < units; u += nwarps) {
      const int r0 = (u % MT) * 16, c0 = (u / MT) * kCols;
      float intra[kNT][4] = {}, inter[kNT][4] = {};
      {
        float low[kNT][4] = {};
        mma_rows<false, kNT>(intra, low, g_s, lg, xs, lx, r0, c0,
                             min(r0 + 16, Q8));
#pragma unroll
        for (int nn = 0; nn < kNT; ++nn)
#pragma unroll
          for (int k = 0; k < 4; ++k) intra[nn][k] += low[nn][k];
      }
      {
        float low[kNT][4] = {};
        mma_rows<true, kNT>(inter, low, ct_s, lt, hs, lx, r0, c0, lay.N8);
#pragma unroll
        for (int nn = 0; nn < kNT; ++nn)
#pragma unroll
          for (int k = 0; k < 4; ++k) inter[nn][k] += low[nn][k];
      }
#pragma unroll
      for (int nn = 0; nn < kNT; ++nn) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = r0 + gq + 8 * hr;
          const int p = c0 + 8 * nn + 2 * tq;
          if (i >= Q || p >= P) continue;
          const float e = ecum[i];
          float o[2];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            o[k] = (intra[nn][2 * hr + k] + e * inter[nn][2 * hr + k]) +
                   dskip * xs[i * lx + p + k];
          float* dst = y + ((row0 + i) * H + h0 + hl) * P + p;
          if (vy) {
            *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
          } else {
            dst[0] = o[0];
            if (p + 1 < P) dst[1] = o[1];
          }
        }
      }
    }
  }
}

// Heads per chunk_state block: enough warp units for the block's warps,
// within 64 KB of shared memory.
int state_group(int H, int P, int N, int Q) {
  const StateSmem one(Q, P, N, 1);
  const int per_head = (one.N16 / 16) * (one.Pw / (8 * kNT));
  int hg = (kStateThreads / 32 + per_head - 1) / per_head;
  hg = hg < H ? hg : H;
  while (hg > 1 && StateSmem(Q, P, N, hg).total * sizeof(float) > 64 * 1024)
    --hg;
  return hg;
}

// Heads per chunk_scan block: C Bᵀ is shared by the group, so the group
// is as large as keeps about 4 blocks per SM of a 132-SM card in the
// grid (at most 8), then the size in the upper half of that range that
// leaves the fewest empty head slots in the last group.
int scan_group(int Bt, int nc, int H) {
  long long cap = static_cast<long long>(Bt) * nc * H / (4 * 132);
  int hmax = static_cast<int>(cap < 1 ? 1 : cap > 8 ? 8 : cap);
  hmax = hmax < H ? hmax : H;
  int best = hmax, waste = (H + hmax - 1) / hmax * hmax - H;
  for (int g = hmax - 1; g >= (hmax + 1) / 2; --g) {
    const int w = (H + g - 1) / g * g - H;
    if (w < waste) best = g, waste = w;
  }
  return best;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int bad_shape(int Bt, int L, int H, int P, int N, int Q) {
  return Bt <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
         Q > kMaxChunk || L % Q != 0;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every tensor is contiguous
// float32: x, y [Bt, L, H, P]; dt [Bt, L, H]; A, D [H]; B, C [Bt, L, N];
// S_loc / h_in [Bt, nc, H, N, P]; total [Bt, nc, H]; state_out
// [Bt, H, N, P] or null (nc = L / Q).  Each launches one kernel on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a shape it
// does not take or shared memory it cannot have).

extern "C" int ssd_chunk_state_launch(const void* x, const void* dt,
                                      const void* A, const void* B,
                                      void* S_loc, void* total, int Bt,
                                      int L, int H, int P, int N, int Q,
                                      void* stream) {
  if (bad_shape(Bt, L, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hg = state_group(H, P, N, Q);
  const size_t smem = StateSmem(Q, P, N, hg).total * sizeof(float);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(ssd_chunk_state),
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = (P % 4 == 0) && aligned16(x);
  const int vec_b = (N % 4 == 0) && aligned16(B);
  const dim3 grid(L / Q, Bt, (H + hg - 1) / hg);
  ssd_chunk_state<<<grid, kStateThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(S_loc), static_cast<float*>(total), L, H, P, N, Q,
      hg, vec, vec_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_state_pass_launch(void* S_loc, const void* total,
                                     void* state_out, int Bt, int nc,
                                     int H, int N, int P, void* stream) {
  if (Bt <= 0 || nc <= 0 || H <= 0 || N <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NP = N * P;
  const int per_block = kPassThreads * 4;
  const dim3 grid((NP + per_block - 1) / per_block, Bt * H);
  ssd_state_pass<<<grid, kPassThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S_loc), static_cast<const float*>(total),
      static_cast<float*>(S_loc), static_cast<float*>(state_out), nc, H, NP);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, const void* D,
                                     const void* h_in, void* y, int Bt,
                                     int L, int H, int P, int N, int Q,
                                     void* stream) {
  if (bad_shape(Bt, L, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = L / Q;
  const int hg = scan_group(Bt, nc, H);
  const ScanSmem lay(Q, P, N, hg);
  const size_t smem = lay.total * sizeof(float);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(ssd_chunk_scan),
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = (P % 4 == 0) && aligned16(x) && aligned16(h_in);
  const dim3 grid(nc, Bt, (H + hg - 1) / hg);
  ssd_chunk_scan<<<grid, kScanThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h_in), static_cast<float*>(y), L, H, P, N,
      Q, hg, vec);
  return static_cast<int>(cudaGetLastError());
}
