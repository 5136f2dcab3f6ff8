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
//   - the block stages window columns in a shared-memory ring of 2w + 1
//     slots, [slot][C][32 streams]: row r reads the 2w columns r-w-1 ..
//     r+w-2 (band slot j holds column r-w+j-1), and before row r the block
//     loads the one new column r+w-2, coalesced (32 consecutive streams per
//     coefficient). The extra slot lets a fast warp write the next column
//     while a slow one still reads the last row, so one barrier per row
//     suffices. 11 x 16 x 32 x 4 B = 22.5 KB at C = 16, w = 5. The ring and
//     the rwn ring take (2w+1)(C+8) x 128 B (SMEM_BYTES, 33,792 B at C = 16,
//     w = 5): static shared memory up to the 48 KB a block gets by default
//     (w <= 7 at C = 16), dynamic shared memory with the opt-in attribute
//     above it (smem.cuh); the wrapper raises ValueError where they pass the
//     232,448 B opt-in (w > 37 at C = 16; ops/fused_dtw.py k5_smem_bytes).
//   - each pair-thread computes rwn = 1/|W[c] - m| for the column entering
//     the ring from its own mean, into its own slot of a shared rwn ring
//     (read back only by the same thread: no barrier needed for it).
//   - per row, it loads its template row T'[r-1] (warp-uniform loads, as
//     K1-K4), its dotm T'[r-1].m (an fp32 FMA chain), and dots T'[r-1] with
//     the 2w ring columns; the DP frontier stays in 2w registers. A warp is
//     32 streams of one pair, so a cell's validity, and the row count, are
//     warp-uniform: invalid cells are skipped without divergence, and
//     out-of-range columns (clip(r-w+j-1, 0, Lm-1) in the TPU kernel) are
//     never read.
//   - the DP recurrence is the reference's: new_j = cost_j + min(prev_{j+1},
//     prev_j), then strictly left to right new_j = min(new_j, cost_j +
//     new_{j-1}); a cell is valid iff 1 <= r - w + j <= min(n, r + w - 1),
//     else +inf; the similarity is slot w+1 of row n-1 (the padded [m-1][n]
//     cell). The dots are the same FMA chains as K4's, so K5 gives K4's bits.
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
constexpr int SLOTS = W2 + 1;  // column ring
constexpr int LANES = 32;      // streams per block
constexpr int MAX_JOBS = 8;    // pairs per block
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");

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

__device__ __forceinline__ int slot_of(int col) { return (col + SLOTS) % SLOTS; }

using Ring = float[SLOTS][C][LANES];
using RwnRing = float[SLOTS][MAX_JOBS][LANES];
constexpr int SMEM_BYTES = (int)(sizeof(Ring) + sizeof(RwnRing));
constexpr bool DYNAMIC = SMEM_BYTES > 48 * 1024;  // the rings in dynamic shared memory
static_assert(SMEM_BYTES <= SMEM_OPTIN, "the rings pass sm_90's shared-memory opt-in");

// Window column `col` of the block's 32 streams into its ring slot, loaded
// by all the block's threads (columns outside [0, Lm) are never read).
__device__ __forceinline__ void load_column(Ring& ring, const Args& a, int col, int b0,
                                            int tid, int nthreads) {
  if (col < 0 || col >= a.Lm) return;
  const int s = slot_of(col);
  for (int i = tid; i < C * LANES; i += nthreads) {
    const int c = i / LANES, lane = i % LANES;
    ring[s][c][lane] = b0 + lane < a.B ? a.win[((size_t)col * C + c) * a.B + b0 + lane] : 0.f;
  }
}

// This thread's guarded 1/|W[col] - m| into its own entry of the rwn ring.
__device__ __forceinline__ void column_rwn(const Ring& ring, RwnRing& rwn_ring,
                                           const float (&m)[C], int col, int Lm, int tx,
                                           int ty) {
  const int s = slot_of(col);
  float acc = 0.f;
  if (col >= 0 && col < Lm) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = ring[s][c][tx] - m[c];
      acc = fmaf(d, d, acc);
    }
  }
  rwn_ring[s][ty][tx] = acc == 0.f ? 0.f : 1.f / sqrtf(acc);
}

__device__ __forceinline__ void score(const Args& a, Ring& ring, RwnRing& rwn_ring) {
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

  // columns -w .. w-2 precede row 1; only 0 .. w-2 exist
  for (int col = 0; col <= W - 2; ++col) load_column(ring, a, col, b0, tid, nthreads);
  __syncthreads();
  for (int col = 0; col <= W - 2; ++col) column_rwn(ring, rwn_ring, m, col, Lm, tx, ty);

  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  float result = INFINITY;

  for (int r = 1; r < nmax; ++r) {
    // row r's new column r+w-2 goes to the slot of column r-w-3, which no
    // thread reads in row r-1 (it reads r-w-2 .. r+w-3)
    load_column(ring, a, r + W - 2, b0, tid, nthreads);
    __syncthreads();
    column_rwn(ring, rwn_ring, m, r + W - 2, Lm, tx, ty);
    if (r >= n) continue;  // this pair is done (warp-uniform)

    float t[C];
    load_row(tp + (r - 1) * C, t);
    float dotm = t[0] * m[0];
#pragma unroll
    for (int c = 1; c < C; ++c) dotm = fmaf(t[c], m[c], dotm);

    float cost[W2], cur[W2];
#pragma unroll
    for (int j = 0; j < W2; ++j) {
      const int cdp = r - W + j;  // DP column (1-based); window column cdp - 1
      cost[j] = INFINITY;
      if (cdp >= 1 && cdp <= n) {  // <= r + W - 1 always holds
        const int s = slot_of(cdp - 1);
        float dot = t[0] * ring[s][0][tx];
#pragma unroll
        for (int c = 1; c < C; ++c) dot = fmaf(t[c], ring[s][c][tx], dot);
        cost[j] = 1.f - (dot - dotm) * rwn_ring[s][ty][tx];
      }
    }
#pragma unroll
    for (int j = 0; j < W2; ++j) {
      const float ins = j + 1 < W2 ? prev[j + 1] : INFINITY;
      cur[j] = cost[j] + fminf(ins, prev[j]);
    }
#pragma unroll
    for (int j = 1; j < W2; ++j) cur[j] = fminf(cur[j], cost[j] + cur[j - 1]);
#pragma unroll
    for (int j = 0; j < W2; ++j) prev[j] = cur[j];
    if (r == n - 1) result = cur[W + 1];
  }
  if (live) a.out[(size_t)p * B + b] = result;
}

template <bool DYN>
__global__ void __launch_bounds__(LANES * MAX_JOBS) score_pairs_v1(Args a) {
  if constexpr (DYN) {
    extern __shared__ float4 smem[];
    score(a, *reinterpret_cast<Ring*>(smem),
          *reinterpret_cast<RwnRing*>(reinterpret_cast<float*>(smem) +
                                      sizeof(Ring) / sizeof(float)));
  } else {
    __shared__ Ring ring;
    __shared__ RwnRing rwn_ring;
    score(a, ring, rwn_ring);
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
  static const cudaError_t attr = opt_in_smem(score_pairs_v1<DYNAMIC>, DYN_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int jy = P < MAX_JOBS ? P : MAX_JOBS;
  const dim3 grid((unsigned)((B + LANES - 1) / LANES), (unsigned)((P + jy - 1) / jy));
  score_pairs_v1<DYNAMIC><<<grid, dim3(LANES, jy), DYN_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
