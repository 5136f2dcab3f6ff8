// K5: the single-row-loop fused band-cost + banded-DTW scorer for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rustpotter_tpu/ops/fused_dtw.py::_kernel (v1,
// driven by fused_dtw_batch(variant=1)). It computes K4's function,
// rustpotter_tpu_torch.ops.fused_dtw.fused_dtw_batch_ref: for every stream b
// and pair p, the banded-DTW similarity of the pre-normalized template T'_p
// against the CMN-normalized LINEAR window (oldest column first). Every pair
// is scored: there is no gate.
//
// Layout (all fp32 unless noted, stream index b innermost), as K4's:
//   win   (Lm, C, B)         linear window
//   means (P, C, B)          per-pair CMN means
//   tpl   (P, W + Lm + W, C) T' = T * rsqrt(|T|^2), zero rows kept at zero,
//                            with W zero rows of padding before and after
//   lens  (P,) i32           pair lengths n
//   out   (P, B)             similarities (the wrapper returns the (B, P) view)
//
// Bound: the work is K4's (chip_smoke.py counts it with profiling.dp_work),
// ~2.2 GFLOP at the bench shapes (B=8192, P=6, Lm=100, C=16, w=5), ~0.033 ms
// at the H100 SXM's 67 TFLOP/s fp32 (non-tensor) peak; its bytes (~56 MB,
// ~0.017 ms at 3.35 TB/s) weigh less. So it is bound by operations.
//
// Design: what sets v1 apart from v2 on the TPU is one row loop in which each
// window column of the band is loaded once and shared by every pair
// (_kernel's `wv`); its rwn and dotm pre-passes and its (8, 128) tiles are
// TPU scheduling and do not carry over. Here:
//   - a block is 32 consecutive streams (threadIdx.x) by up to 8 pairs
//     (threadIdx.y); one thread = one (stream, pair). More than 8 pairs take
//     a second block row (blockIdx.y). Threads with b >= B or p >= P do no
//     scoring but take part in the column loads and barriers.
//   - the row loop takes RS DP rows per step. Rows r0 ... r0+RS-1 read the
//     SPAN = 2w + RS - 1 window columns r0-w-1 ... r0+w+RS-3 (band slot j
//     of row r holds column r-w+j-1), which the block stages in a shared
//     ring of SLOTS = SPAN + RS column slots: before the step's one barrier
//     it loads the step's RS new columns, coalesced; the RS spare slots let
//     a fast warp write them while a slow one still reads the step before.
//     Column col lives in slot (col + w) mod SLOTS, counted incrementally:
//     the step's base slot advances by RS and each band column's slot by
//     one, wrapped by a compare (no run-time modulo). A slot holds window
//     column clip(col, 0, Lm-1), as the TPU kernel clips, so every band slot
//     reads a column that exists.
//   - the ring is chunk-major, [slot][C/4][32 streams][4] (C % 4 == 0): a
//     thread reads a column's C values with C/4 LDS.128, and a quarter-warp's
//     LDS.128 covers 128 contiguous bytes, free of bank conflicts with no
//     swizzle; other C take [slot][C][32] and LDS.32. Reading 4 values per
//     load took 27-31 % off the time over the same bytes: the number of load
//     instructions, not shared-memory bandwidth, bounded the scalar ring
//     (PERF.md).
//   - each pair-thread computes rwn = rsqrt(|W[c] - m|^2) (0 for a zero
//     norm) of each column entering the ring from its own mean, into its own
//     entry of a shared rwn ring (read back only by the same thread: no
//     barrier needed for it).
//   - per step, it loads its RS template rows T'[r-1] (warp-uniform loads,
//     as K1-K4) and their dotm T'[r-1].m, then for each of the SPAN ring
//     columns its C values and the dots of the RS rows whose band holds it:
//     a column read once feeds up to RS dots. The step is branch-free: every
//     dot is computed, and a cell outside 1 <= cdp <= n takes +inf by a
//     select, so that the compiler interleaves all RS x 2w dot chains. The
//     DP frontier stays in 2w registers, the step's costs in RS x 2w.
//   - RS = 3, but 2 where 3 rows' registers (~156 at w = 5, C = 16) would
//     leave a block of 6 pair-warps no second resident block (6 <= w <= 12)
//     or spill (w > 28), and fewer where the ring would pass the opt-in
//     (w = 36, 37 at C = 16): measured at w = 5, 7, 9, 13, 19, 28, 36, 37
//     (PERF.md). At the bench shapes RS = 3 took 141 us against 161 for 2,
//     203 for 1 and the parent's 333 (guarded slots, scalar loads).
//   - the ring and the rwn ring take SLOTS x (C + 8) x 128 B (SMEM_BYTES):
//     static shared memory up to the 48 KB a block gets by default, dynamic
//     shared memory with the opt-in attribute above it (smem.cuh); the
//     wrapper raises ValueError where they pass the 232,448 B opt-in (w > 37
//     at C = 16, as the parent; ops/fused_dtw.py k5_smem_bytes).
//   - the DP recurrence is the reference's: new_j = cost_j + min(prev_{j+1},
//     prev_j), then strictly left to right new_j = min(new_j, cost_j +
//     new_{j-1}); a cell is valid iff 1 <= r - w + j <= min(n, r + w - 1),
//     else +inf; the similarity is slot w+1 of row n-1 (the padded [m-1][n]
//     cell). The dot and dotm chains and rwn (rsqrtf) are K4's, in K4's
//     order; the cost 1 - (dot - dotm) rwn is one FMA in every slot. K4's
//     compiled code fuses it in all slots but 2w-1, where it rounds the
//     product first, so K5 gives K4's bits except in the sims whose path
//     takes such a cell (~0.5 % at the bench shapes, 1-2 ulp).
#include <cuda_runtime.h>
#include <math.h>

#include "smem.cuh"

#ifndef RP_C
#error "compile with -DRP_C=<mfcc coefficients>"
#endif
#ifndef RP_W
#error "compile with -DRP_W=<band size>"
#endif

namespace {

constexpr int C = RP_C;
constexpr int W = RP_W;
constexpr int W2 = 2 * W;
constexpr int LANES = 32;    // streams per block
constexpr int MAX_JOBS = 8;  // pairs per block
// DP rows per step: 3, but 2 where 3 rows' registers would cost a block of
// 6 pair-warps its second resident block (6 <= w <= 12 at C = 16) and where
// they spill (w > 28); fewer where the ring would pass the opt-in (PERF.md)
constexpr int RS_WANT = W <= 5 || (W >= 13 && W <= 28) ? 3 : 2;
constexpr int SLOT_BYTES = 4 * (C + MAX_JOBS) * LANES;  // a column slot and its rwn slot
constexpr bool WANT_FITS = (W2 + 2 * RS_WANT - 1) * SLOT_BYTES <= SMEM_OPTIN;
constexpr bool TWO_FIT = (W2 + 3) * SLOT_BYTES <= SMEM_OPTIN;
constexpr int RS = WANT_FITS ? RS_WANT : TWO_FIT ? 2 : 1;
constexpr int SPAN = W2 + RS - 1;  // window columns a step reads
constexpr int SLOTS = SPAN + RS;   // and the next step's new ones
constexpr int SMEM_BYTES = SLOTS * SLOT_BYTES;
// the ring's layout: chunk-major [slot][C/4][32 lanes][4] where C % 4 == 0,
// so that a quarter-warp's LDS.128 reads 128 contiguous bytes; else
// [slot][C][32 lanes]. Either way a warp's load is free of bank conflicts.
constexpr bool VEC = C % 4 == 0;
constexpr bool DYNAMIC = SMEM_BYTES > 48 * 1024;  // the rings in dynamic shared memory
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(SMEM_BYTES <= SMEM_OPTIN, "the rings pass sm_90's shared-memory opt-in");

struct Args {
  const float* win;
  const float* means;
  const float* tpl;
  const int* lens;
  float* out;
  int B, Lm, P;
};

// The C values of a T' row (the same address in every lane of a warp).
__device__ __forceinline__ void load_row(const float* t, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(t) + q);
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(t + c);
  }
}

// v[0]*x[0] + ... as one fp32 FMA chain (K4's order).
__device__ __forceinline__ float dot(const float (&v)[C], const float (&x)[C]) {
  float acc = v[0] * x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = fmaf(v[c], x[c], acc);
  return acc;
}

__device__ __forceinline__ int wrap(int s) { return s >= SLOTS ? s - SLOTS : s; }

// Lane tx's C values of the column in ring slot s: C/4 LDS.128 in the
// chunk-major layout, else C LDS.32.
__device__ __forceinline__ void read_column(const float* ring, int s, int tx, float (&x)[C]) {
  const float* col = ring + s * (C * LANES);
  if constexpr (VEC) {
    const float4* p = reinterpret_cast<const float4*>(col) + tx;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 f = p[q * LANES];
      x[4 * q] = f.x; x[4 * q + 1] = f.y; x[4 * q + 2] = f.z; x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = col[c * LANES + tx];
  }
}

// Window column clip(col, 0, Lm - 1) of the block's 32 streams into ring
// slot s, loaded by all the block's threads: in the chunk-major layout a
// thread takes 4 coefficients of one stream (4 coalesced loads, one STS.128).
__device__ __forceinline__ void load_column(float* ring, const Args& a, int col, int s, int b0,
                                            int tid, int nthreads) {
  const float* src = a.win + (size_t)min(max(col, 0), a.Lm - 1) * C * a.B + b0;
  float* dst = ring + s * (C * LANES);
  const int live = min(LANES, a.B - b0);
  if constexpr (VEC) {
    for (int i = tid; i < C / 4 * LANES; i += nthreads) {
      const int q = i / LANES, lane = i % LANES;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < live) {
        const float* g = src + (size_t)(4 * q) * a.B + lane;
        f = make_float4(g[0], g[a.B], g[2 * (size_t)a.B], g[3 * (size_t)a.B]);
      }
      reinterpret_cast<float4*>(dst)[i] = f;
    }
  } else {
    for (int i = tid; i < C * LANES; i += nthreads) {
      const int c = i / LANES, lane = i % LANES;
      dst[i] = lane < live ? src[(size_t)c * a.B + lane] : 0.f;
    }
  }
}

// This thread's rsqrt(|W - m|^2) of the column in slot s, 0 for a zero norm.
__device__ __forceinline__ float column_rwn(const float* ring, int s, int tx,
                                            const float (&m)[C]) {
  float x[C];
  read_column(ring, s, tx, x);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = x[c] - m[c];
    acc = fmaf(d, d, acc);
  }
  return acc == 0.f ? 0.f : rsqrtf(acc);
}

__device__ __forceinline__ void score(const Args& a, float* ring, float* rwn_ring) {
  const int B = a.B, Lm = a.Lm;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int jy = blockDim.y;
  const int tid = ty * LANES + tx;
  const int nthreads = LANES * jy;
  const int b0 = blockIdx.x * LANES;
  const int b = b0 + tx;
  const int p = blockIdx.y * jy + ty;
  const bool live = b < B && p < a.P;
  const int n = p < a.P ? a.lens[p] : 0;  // 1 <= n <= Lm for real pairs
  float* rwn = rwn_ring + ty * LANES + tx;  // this thread's entry of slot s: rwn[s * STRIDE]
  constexpr int STRIDE = MAX_JOBS * LANES;

  // rows of the longest pair of this block: the loop, and so the barriers,
  // are the same for every thread
  int nmax = 0;
  for (int q = blockIdx.y * jy; q < min(a.P, (blockIdx.y + 1) * jy); ++q)
    nmax = max(nmax, a.lens[q]);

  float m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = live ? a.means[((size_t)p * C + c) * B + b] : 0.f;
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)min(p, a.P - 1) * (Lm + W2) + W) * C;

  // columns -W ... W-2 precede the first step, in slots 0 ... 2W-2
  for (int s = 0; s <= W2 - 2; ++s) load_column(ring, a, s - W, s, b0, tid, nthreads);
  __syncthreads();
  for (int s = 0; s <= W2 - 2; ++s) rwn[s * STRIDE] = column_rwn(ring, s, tx, m);

  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  float result = INFINITY;

  int base = 0;  // the slot of column r0 - W - 1, the step's first band column
  for (int r0 = 1; r0 < nmax; r0 += RS, base = wrap(base + RS)) {
    // the step's new columns r0+W-2 ... r0+W+RS-3 go to slots base+2W-1 ...,
    // which held columns that no thread reads in the step before
#pragma unroll
    for (int k = 0; k < RS; ++k)
      load_column(ring, a, r0 + W - 2 + k, wrap(base + W2 - 1 + k), b0, tid, nthreads);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RS; ++k) {
      const int s = wrap(base + W2 - 1 + k);
      rwn[s * STRIDE] = column_rwn(ring, s, tx, m);
    }
    if (r0 >= n) continue;  // this pair is done (warp-uniform)

    float t[RS][C], dotm[RS];
#pragma unroll
    for (int k = 0; k < RS; ++k) {
      load_row(tp + (r0 - 1 + k) * C, t[k]);
      dotm[k] = dot(t[k], m);
    }
    // the band step: row r0+k reads column i of the span at band slot i-k
    float cost[RS][W2];
    int s = base;
#pragma unroll
    for (int i = 0; i < SPAN; ++i, s = wrap(s + 1)) {
      float x[C];
      read_column(ring, s, tx, x);
      const float rw = rwn[s * STRIDE];
#pragma unroll
      for (int k = 0; k < RS; ++k) {
        const int j = i - k;
        if (j < 0 || j >= W2) continue;  // compile-time
        const int cdp = r0 + k - W + j;  // DP column; window column cdp - 1
        const float cell = fmaf(-(dot(t[k], x) - dotm[k]), rw, 1.f);  // 1 - (dot - dotm) rw
        cost[k][j] = cdp >= 1 && cdp <= n ? cell : INFINITY;  // <= r + W - 1 always holds
      }
    }
#pragma unroll
    for (int k = 0; k < RS; ++k) {
      if (k > 0 && r0 + k >= n) break;  // warp-uniform
      float cur[W2];
#pragma unroll
      for (int j = 0; j < W2; ++j) {
        const float ins = j + 1 < W2 ? prev[j + 1] : INFINITY;
        cur[j] = cost[k][j] + fminf(ins, prev[j]);
      }
#pragma unroll
      for (int j = 1; j < W2; ++j) cur[j] = fminf(cur[j], cost[k][j] + cur[j - 1]);
#pragma unroll
      for (int j = 0; j < W2; ++j) prev[j] = cur[j];
      if (r0 + k == n - 1) result = cur[W + 1];
    }
  }
  if (live) a.out[(size_t)p * B + b] = result;
}

template <bool DYN>
__global__ void __launch_bounds__(LANES * MAX_JOBS) score_pairs_v1(Args a) {
  constexpr int RING = SLOTS * C * LANES;  // floats of the column ring; the rwn ring follows
  if constexpr (DYN) {
    extern __shared__ float4 smem[];
    score(a, reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + RING);
  } else {
    __shared__ float4 rings[SMEM_BYTES / 16];
    score(a, reinterpret_cast<float*>(rings), reinterpret_cast<float*>(rings) + RING);
  }
}

}  // namespace

// Launch K5 on `stream`. Returns cudaGetLastError() after the launch: a
// refused launch (bad grid, too many resources) never runs, so the caller
// must check this value.
extern "C" int rp_fused_dtw_v1(const void* win, const void* means,
                               const void* tpl, const void* lens, void* out,
                               void* stream, int B, int Lm, int P) {
  const Args a{static_cast<const float*>(win), static_cast<const float*>(means),
               static_cast<const float*>(tpl), static_cast<const int*>(lens),
               static_cast<float*>(out),       B, Lm, P};
  constexpr int DYN_BYTES = DYNAMIC ? SMEM_BYTES : 0;
  static SmemOptIn opt_in;
  const cudaError_t attr = opt_in(score_pairs_v1<DYNAMIC>, DYN_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int jy = P < MAX_JOBS ? P : MAX_JOBS;
  const dim3 grid((unsigned)((B + LANES - 1) / LANES), (unsigned)((P + jy - 1) / jy));
  score_pairs_v1<DYNAMIC><<<grid, dim3(LANES, jy), DYN_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
