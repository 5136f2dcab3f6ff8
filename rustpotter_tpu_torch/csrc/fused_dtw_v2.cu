// K4: the ungated linear-window fused band-cost + banded-DTW scorer for
// Hopper (sm_90a).
//
// Replaces the TPU kernel rustpotter_tpu/ops/fused_dtw.py::_kernel_v2 (driven
// by fused_dtw_batch(variant=2)). It computes the function of
// rustpotter_tpu_torch.ops.fused_dtw.fused_dtw_batch_ref: for every stream b
// and pair p, the banded-DTW similarity of the pre-normalized template T'_p
// against the CMN-normalized LINEAR window (oldest column first; the caller
// gathers it out of the circular buffer, as the JAX package's jnp.roll does).
// Every pair is scored: there is no gate.
//
// Layout (all fp32 unless noted, stream index b innermost):
//   win   (Lm, C, B)         linear window
//   means (P, C, B)          per-pair CMN means
//   tpl   (P, W + Lm + W, C) T' = T * rsqrt(|T|^2), zero rows kept at zero,
//                            with W zero rows of padding before and after
//   lens  (P,) i32           pair lengths n
//   out   (P, B)             similarities (the wrapper returns the (B, P) view)
//
// Bound at the bench shapes (B=8192, P=6, Lm=100, C=16, w=5): per stream and
// pair of length n, rwn over n columns and, per DP row r < n, the dotm chain
// (2C), the dots of the valid band cells (2C each), their mean correction and
// the DP: ~2.2 GFLOP, ~0.033 ms at the H100 SXM's 67 TFLOP/s fp32 (non-tensor)
// peak; its bytes (window 52 MB, means 3 MB, output) are ~56 MB, ~0.017 ms at
// 3.35 TB/s. So it is bound by operations; chip_smoke.py computes both.
//
// Design: the TPU kernel's two phases (a cost band in VMEM, then one DP per
// pair) are its answer to the TPU's register file; they do not carry over.
// This is K1's (csrc/fused_dtw_v4.cu) column ring with one window and no gate:
//   - a block is 32 consecutive streams (threadIdx.x) by up to 8 pairs
//     (threadIdx.y); one thread = one (stream, pair). Threads with b >= B do
//     no work. One launch.
//   - the thread walks the window's columns once, in order. Column c (C
//     values, a coalesced load, prefetched one column ahead) gives its
//     guarded inverse norm rwn = 1/|W[c] - m| and is dotted with the 2w
//     template rows whose band holds it, r - 1 = c + w - j for band slot j:
//     cost(r, j) = 1 - (T'[r-1].W[c] - T'[r-1].m) * rwn. T'[t].m is an fp32
//     FMA chain, computed once per template row into a ring of 2w. The costs
//     wait in a 2w x 2w register ring until their row is whole (after column
//     r + w - 2); then that row takes the DP step. The column loop is
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
  const float* tpl;
  const int* lens;
  float* out;
  int B, Lm, P;
};

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

  float m[C];
  load_column(a.means + (size_t)p * C * B + b, B, m);
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  const float* col = a.win + b;  // column c at col + c * C * B

  float dm[W2];  // dm[ring(t)] = T'[t].m
#pragma unroll
  for (int t = -W + 1; t < W; ++t) dm[ring(t)] = dot_row(tp + t * C, m);
  float pend[W2][W2];  // pend[ring(r)][j] = cost of DP row r, band slot j
  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;

  float nxt[C];
  load_column(col, B, nxt);
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
        if (c + 1 < n) load_column(col + (size_t)(c + 1) * C * B, B, nxt);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float d = x[i] - m[i];
          acc = fmaf(d, d, acc);
        }
        const float rwn = acc == 0.f ? 0.f : 1.f / sqrtf(acc);
        dm[ring(k + W)] = dot_row(tp + (c + W) * C, m);
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

__global__ void __launch_bounds__(LANES * MAX_JOBS) score_pairs_v2(Args a) {
  const int b = blockIdx.x * LANES + threadIdx.x;
  const int p = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= a.B || p >= a.P) return;
  a.out[(size_t)p * a.B + b] = pair_sim(a, p, b);
}

}  // namespace

// Launch K4 on `stream`. Returns cudaGetLastError() after the launch: a
// refused launch (bad grid, too many resources) never runs, so the caller
// must check this value.
extern "C" int rp_fused_dtw_v2(const void* win, const void* means,
                               const void* tpl, const void* lens, void* out,
                               void* stream, int B, int Lm, int P) {
  const Args a{static_cast<const float*>(win), static_cast<const float*>(means),
               static_cast<const float*>(tpl), static_cast<const int*>(lens),
               static_cast<float*>(out),       B, Lm, P};
  const int jy = P < MAX_JOBS ? P : MAX_JOBS;
  const dim3 grid((unsigned)((B + LANES - 1) / LANES), (unsigned)((P + jy - 1) / jy));
  score_pairs_v2<<<grid, dim3(LANES, jy), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
