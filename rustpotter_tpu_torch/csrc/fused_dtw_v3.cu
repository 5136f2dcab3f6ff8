// K2: the per-shift fused band-cost + banded-DTW scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel rustpotter_tpu/ops/fused_dtw.py::_kernel_v3 (driven
// by fused_dtw_batch_v3_t). It computes the function of
// rustpotter_tpu_torch.ops.fused_dtw.fused_dtw_batch_v3_ref: for every stream b
// and template pair p, the banded-DTW similarity of the pre-normalized
// template T'_p against the CMN-normalized circular window of one MFCC shift,
// with each wakeword's avg pair gating its template pairs.
//
// Layout (all fp32 unless noted, stream index b innermost, so a warp's 32
// consecutive streams read 128 contiguous bytes):
//   win   (F, C, B)          circular window, cursor *rot (i32): logical
//                            column i lives at physical row (rot + 1 + i) % F
//   means (P, C, B)          per-pair CMN means
//   dotm  (P, Lm, B)         T'[t] . m per pair, row and stream (an fp32
//                            einsum outside the kernel)
//   tpl   (P, W + Lm + W, C) T' = T * rsqrt(|T|^2), zero rows kept at zero,
//                            with W zero rows of padding before and after
//   lens  (P,) i32           pair lengths n; gate (D,) sim-domain avg-gate bounds
//   out   (P, B)             similarities (the wrapper returns the (B, P) view)
// Pair order: p = d*K + k for templates, then D*K + d for the avg pairs.
//
// Bound at the bench shapes (B=8192, P=6, Lm=F=100, C=16, w=5, gate open):
// per stream, pair of length n and DP row r < n, the dots of the valid band
// cells (2C FLOP each), their mean correction and the DP; per column rwn.
// That is ~2.1 GFLOP per shift, ~0.032 ms at the H100 SXM's 67 TFLOP/s fp32
// (non-tensor) peak; its bytes (window 52 MB, dotm 20 MB, means 3 MB, output)
// are ~75 MB, ~0.022 ms at 3.35 TB/s. So it is bound by operations, though
// not by far; chip_smoke.py computes both from its inputs.
//
// Design: K1's (csrc/fused_dtw_v4.cu) column ring restricted to one shift with
// no new rows, and dotm read from its input instead of computed:
//   - two launches on one stream: the avg pairs, then the template pairs. A
//     template thread reads its wakeword's avg similarity and, if avg >
//     gate[d] (or NaN), writes +inf and exits. The gate is decided per
//     stream, finer than the TPU's (8, 128)-tile decision and
//     detection-equivalent, because the score-domain gate downstream is per
//     stream.
//   - a block is 32 consecutive streams (threadIdx.x) by up to 8 pairs
//     (threadIdx.y); the warps of a block read the same streams' window
//     columns, so they share them in L1. Threads with b >= B do no work.
//   - one thread = one (stream, pair). It walks the window's logical columns
//     once, in order. Column c (C values, a coalesced load, prefetched one
//     column ahead) gives its guarded inverse norm rwn = 1/|W[c] - m| and is
//     dotted with the 2w template rows whose band holds it, r - 1 = c + w - j
//     for band slot j: cost(r, j) = 1 - (T'[r-1].W[c] - dotm[r-1]) * rwn. The
//     costs wait in a 2w x 2w register ring until their row is whole (after
//     column r + w - 2); then that row takes the DP step. The column loop is
//     unrolled by 2w so every ring index is a compile-time constant (C and w
//     are compile-time: -DRP_C, -DRP_W).
//   - DP recurrence, as the reference: new_j = cost_j + min(prev_{j+1}, prev_j),
//     then strictly left to right new_j = min(new_j, cost_j + new_{j-1}); a
//     cell is valid iff 1 <= r - w + j <= min(n, r + w - 1), else +inf; the
//     similarity is slot w+1 of row n-1 (the padded [m-1][n] cell).
#include <cuda_runtime.h>
#include <math.h>

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
constexpr int LANES = 32;   // streams per block
constexpr int MAX_JOBS = 8; // pairs per block
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");

struct Args {
  const float* win;
  const float* means;
  const float* dotm;
  const float* tpl;
  const int* lens;
  const float* gate;
  const int* rot;
  float* out;
  int B, F, Lm, D, K, P;
};

// Element 0 of logical column i for stream b (element c is at [c * B]).
__device__ __forceinline__ const float* column(const Args& a, int rot, int i,
                                               int b) {
  int ph = rot + 1 + i;  // < 2F: rot < F and i < Lm <= F
  if (ph >= a.F) ph -= a.F;
  return a.win + (size_t)ph * C * a.B + b;
}

__device__ __forceinline__ void load_column(const float* p, int B, float (&x)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = p[(size_t)c * B];
}

// t[0]*x[0] + ... as one fp32 FMA chain; t is a warp-uniform T' row.
__device__ __forceinline__ float dot_row(const float* t, const float (&x)[C]) {
  float v[C];
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
  float acc = v[0] * x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = fmaf(v[c], x[c], acc);
  return acc;
}

__host__ __device__ constexpr int ring(int i) { return ((i % W2) + W2) % W2; }

__device__ float pair_sim(const Args& a, int p, int b) {
  const int B = a.B;
  const int n = a.lens[p];  // 1 <= n <= Lm
  if (n < 2) return INFINITY;
  int rot = *a.rot;

  float m[C];
  load_column(a.means + (size_t)p * C * B + b, B, m);
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  // dotm row t of pair p for stream b is dm_p[t * B], 0 <= t < Lm; rows
  // outside it belong to zero (padding) template rows
  const float* dm_p = a.dotm + (size_t)p * a.Lm * B + b;
  auto dotm_at = [&](int t) { return t >= 0 && t < a.Lm ? dm_p[(size_t)t * B] : 0.f; };

  float dm[W2];  // dm[ring(t)] = T'[t].m
#pragma unroll
  for (int t = -W + 1; t < W; ++t) dm[ring(t)] = dotm_at(t);
  float pend[W2][W2];  // pend[ring(r)][j] = cost of DP row r, band slot j
  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;

  float nxt[C];
  load_column(column(a, rot, 0, b), B, nxt);
  // row r is whole after column r + W - 2; the last row is n - 1
  const int cend = n + W - 2;
  for (int c0 = 0; c0 < cend; c0 += W2) {
#pragma unroll
    for (int k = 0; k < W2; ++k) {
      const int c = c0 + k;  // c0 % W2 == 0, so ring(c + x) == ring(k + x)
      if (c >= cend) break;
      if (c < n) {
        float x[C];
#pragma unroll
        for (int i = 0; i < C; ++i) x[i] = nxt[i];
        if (c + 1 < n) load_column(column(a, rot, c + 1, b), B, nxt);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float d = x[i] - m[i];
          acc = fmaf(d, d, acc);
        }
        const float rwn = acc == 0.f ? 0.f : 1.f / sqrtf(acc);
        dm[ring(k + W)] = dotm_at(c + W);
#pragma unroll
        for (int j = 0; j < W2; ++j) {
          // template row c + W - j = DP row r - 1, band slot j
          const float dot = dot_row(tp + (c + W - j) * C, x);
          pend[ring(k + W + 1 - j)][j] = 1.f - (dot - dm[ring(k + W - j)]) * rwn;
        }
      } else {
        // past the last column: these cells are invalid. Writing them keeps
        // every ring entry written before it is read.
#pragma unroll
        for (int j = 0; j < W2; ++j) pend[ring(k + W + 1 - j)][j] = INFINITY;
      }
      const int r = c - W + 2;
      if (r >= 1) {
        const int hi = min(n, r + W - 1);
        float cost[W2], cur[W2];
#pragma unroll
        for (int j = 0; j < W2; ++j) {
          const int cdp = r - W + j;
          cost[j] = cdp >= 1 && cdp <= hi ? pend[ring(k - W + 2)][j] : INFINITY;
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
      }
    }
  }
  return prev[W + 1];
}

// Pairs `pair0` .. `pair0 + npairs - 1` for every stream.
__global__ void __launch_bounds__(LANES * MAX_JOBS)
    score_pairs_v3(Args a, int pair0, int npairs, bool gated) {
  const int b = blockIdx.x * LANES + threadIdx.x;
  const int job = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= a.B || job >= npairs) return;
  const int p = pair0 + job;
  float sim = INFINITY;
  // a NaN avg similarity keeps the gate closed, as the TPU kernel's compare
  const int d = p / a.K;
  if (!gated || a.out[(size_t)(a.D * a.K + d) * a.B + b] <= a.gate[d])
    sim = pair_sim(a, p, b);
  a.out[(size_t)p * a.B + b] = sim;
}

cudaError_t launch(const Args& a, int pair0, int npairs, bool gated,
                   cudaStream_t st) {
  const int jy = npairs < MAX_JOBS ? npairs : MAX_JOBS;
  const dim3 grid((unsigned)((a.B + LANES - 1) / LANES),
                  (unsigned)((npairs + jy - 1) / jy));
  score_pairs_v3<<<grid, dim3(LANES, jy), 0, st>>>(a, pair0, npairs, gated);
  return cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`. Returns cudaGetLastError() after the launches: a
// refused launch (bad grid, too many resources) never runs, so the caller
// must check this value.
extern "C" int rp_fused_dtw_v3(const void* win, const void* means,
                               const void* dotm, const void* tpl,
                               const void* lens, const void* gate,
                               const void* rot, void* out, void* stream,
                               int B, int F, int Lm, int D, int K) {
  const Args a{static_cast<const float*>(win),  static_cast<const float*>(means),
               static_cast<const float*>(dotm), static_cast<const float*>(tpl),
               static_cast<const int*>(lens),   static_cast<const float*>(gate),
               static_cast<const int*>(rot),    static_cast<float*>(out),
               B, F, Lm, D, K, D * K + D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(a, D * K, D, false, st);
  if (err != cudaSuccess || D * K == 0) return (int)err;
  return (int)launch(a, 0, D * K, true, st);
}
