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
// That is ~2.0 GFLOP per shift, ~0.030 ms at the H100 SXM's 67 TFLOP/s fp32
// (non-tensor) peak; its bytes (window 52 MB, dotm 20 MB, means 3 MB, output)
// are ~75 MB, ~0.022 ms at 3.35 TB/s. So it is bound by operations, though
// not by far; chip_smoke.py computes both from its inputs. Tensor cores are
// no help: the port is true fp32 and wgmma has no fp32 form.
//
// Design: the window's columns are split over Q producer warps, and one more
// warp takes the DP; they pass the band costs through a shared ring.
//   - two launches on one stream: the avg pairs, then the template pairs. A
//     template block reads its streams' avg similarities; a stream whose avg
//     is > gate[d] (or NaN) gets +inf, and a block where no stream passes
//     writes +inf and exits. The gate is decided per stream, finer than the
//     TPU's (8, 128)-tile decision and detection-equivalent, because the
//     score-domain gate downstream is per stream.
//   - a block is 32 consecutive streams (threadIdx.x, one per lane) by
//     WARPS = Q + 1 = 5 warps (threadIdx.y; Q = 3 at w = 20) of one pair;
//     the pair is the fastest grid index, so that the blocks of one group of
//     streams run side by side and read its window columns from L2 once
//     (7 % faster than the streams first, PERF.md). One thread per
//     (stream, pair) would give the avg launch 256 warps at B = 8192, 2 per
//     SM, each a serial chain of n + w - 2 column steps; five warps give it
//     9.7 per SM.
//   - round u: producer warp q (1 ... Q) takes column k = u*Q + q - 1 whole:
//     its C values (a coalesced load, prefetched one round ahead), rwn(k) =
//     rsqrt(|W[k] - m|^2) (0 where the squared norm is 0 or k >= n), and the
//     2w band costs of the column, cost(t, j) = 1 - (T'[t].W[k] - dotm[t]) *
//     rwn(k) for the template rows t = k + w - j whose DP row t + 1 holds it
//     at band slot j (each dot one fp32 FMA chain over c, in order; dotm
//     prefetched one round ahead). It stores them in the ring, laid out
//     [row t mod R][slot j][lane] so that every store and load of a warp is
//     one conflict-free wavefront. One __syncthreads per round; then warp 0
//     takes the DP steps of the Q rows that the round's columns complete
//     (row t is whole after column t + w - 1), reading 2w costs per row,
//     while the producers run the next round. Splitting the columns, not a
//     column's dots, keeps every column's load, rwn and row addressing in
//     one warp: split over 5 warps, a column's 2w dots cost each warp the
//     column's load and addresses for 2 dots, which measured slower than one
//     thread per (stream, pair) (PERF.md).
//   - the ring: row t's slot j is written in the round of column t - w + j
//     and read in the round of column t + w - 1. Row t + R writes the same
//     slot while warp 0 may still run the round before it: so the write
//     must come two rounds after the read, which holds for every t, whatever
//     its place in its round, when R >= 2w + 2Q - 1
//     (tests/test_torch_k2_schedule.py runs every round's writes before the
//     previous round's reads; 2w + 2Q - 2 rows fail it). At w = 5 the ring is
//     17 x 10 x 32 floats, 21,760 B per block (dynamic shared memory); it
//     grows with w. At w = 20 three producers keep it inside sm_90's 227 KB
//     opt-in, and W_MAX = 20 is the largest band whose ring fits. Ring rows
//     are counted incrementally: no run-time modulo.
//   - the producer's column step is branch-free: the dot chains are
//     unguarded, with clamped rows, and only the ring stores are predicated,
//     so that the compiler schedules them as one basic block; rwn is rsqrtf
//     (2 ulp). A guard per chain (and an IEEE 1/sqrtf) made each its own
//     basic block and cost K1 1.3x (PERF.md). C and w are compile-time:
//     -DRP_C, -DRP_W.
//   - DP recurrence, as the reference: new_j = cost_j + min(prev_{j+1}, prev_j),
//     then strictly left to right new_j = min(new_j, cost_j + new_{j-1}); a
//     cell is valid iff 1 <= r - w + j <= min(n, r + w - 1), else +inf; the
//     similarity is slot w+1 of row n-1 (the padded [m-1][n] cell).
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
constexpr int LANES = 32;           // streams per block
constexpr int Q = W <= 19 ? 4 : 3;  // producer warps: columns per round
constexpr int WARPS = Q + 1;         // and the DP warp
constexpr int R = W2 + 2 * Q - 1;    // rows of the shared cost ring
constexpr int RING_BYTES = 4 * R * W2 * LANES;
constexpr int W_MAX = 20;
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(W <= W_MAX && RING_BYTES <= SMEM_OPTIN,
              "W_MAX = 20 is the largest band whose ring fits the shared-memory opt-in");

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
__device__ __forceinline__ const float* column(const Args& a, int rot, int i, int b) {
  int ph = rot + 1 + i;  // < 2F: rot < F and i < Lm <= F
  if (ph >= a.F) ph -= a.F;
  return a.win + (size_t)ph * C * a.B + b;
}

__device__ __forceinline__ void load_column(const float* p, int B, float (&x)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = __ldg(p + (size_t)c * B);
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

// One launch: pairs pair0 ... pair0 + gridDim.x - 1 of every stream.
__global__ void __launch_bounds__(LANES * WARPS)
    score_pairs_v3(Args a, int pair0, bool gated) {
  extern __shared__ float costs[];  // the cost ring [R][W2][LANES]
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int p = pair0 + blockIdx.x;
  const int b = blockIdx.y * LANES + lane;
  const bool live = b < a.B;
  const int bl = live ? b : a.B - 1;  // threads past B load stream B-1
  const size_t o = (size_t)p * a.B + b;
  const int n = a.lens[p];  // 1 <= n <= Lm
  bool open = live;
  if (gated && live) {
    // a NaN avg similarity keeps the gate closed, as the TPU kernel's compare
    const int d = p / a.K;
    open = a.out[(size_t)(a.D * a.K + d) * a.B + b] <= a.gate[d];
  }
  if (n < 2 || !__syncthreads_or(open)) {
    if (live && g == 0) a.out[o] = INFINITY;
    return;
  }
  float* ring_lane = costs + lane;
  const int kend = n + W - 2;  // DP row n-1 is whole after column n + W - 3
  const int rounds = (kend + Q - 1) / Q;

  if (g == 0) {
    // the DP warp: rows t = u*Q - W + 1 ... u*Q + Q - W in round u
    float prev[W2];
#pragma unroll
    for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
    int t = -W + 1;
    int row = R - W + 1;  // t % R
    for (int u = 0; u < rounds; ++u) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Q; ++i, ++t, row = row + 1 == R ? 0 : row + 1) {
        if (t < 0 || t > n - 2) continue;
        const int r = t + 1;
        const int hi = min(n, r + W - 1);
        const float* rp = ring_lane + row * W2 * LANES;
        float cost[W2], cur[W2];
#pragma unroll
        for (int j = 0; j < W2; ++j) {
          const int cdp = r - W + j;
          cost[j] = cdp >= 1 && cdp <= hi ? rp[j * LANES] : INFINITY;
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
    if (live) a.out[o] = open ? prev[W + 1] : INFINITY;
    return;
  }

  // a producer warp: column k = u*Q + g - 1 in round u
  const int rot = *a.rot;
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  // dotm row t of pair p for stream bl is dm_p[t * B], 0 <= t < Lm
  const float* dm_p = a.dotm + (size_t)p * a.Lm * a.B + bl;
  float m[C];
  load_column(a.means + (size_t)p * C * a.B + bl, a.B, m);
  int k = g - 1;
  float nxt[C], dmn[W2];  // column k and the dotm of its rows, loaded a round ahead
  load_column(column(a, rot, min(k, n - 1), bl), a.B, nxt);
#pragma unroll
  for (int j = 0; j < W2; ++j) dmn[j] = __ldg(dm_p + (size_t)min(max(k + W - j, 0), n - 2) * a.B);
  int base = (k + W) % R;  // the ring row of template row k + W (band slot 0)
  for (int u = 0; u < rounds; ++u, k += Q, base = base + Q >= R ? base + Q - R : base + Q) {
    if (k < kend) {
      float x[C], dm[W2];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = nxt[c];
#pragma unroll
      for (int j = 0; j < W2; ++j) dm[j] = dmn[j];
      // the next round's column and dotm rows, clamped into range
      load_column(column(a, rot, min(k + Q, n - 1), bl), a.B, nxt);
#pragma unroll
      for (int j = 0; j < W2; ++j)
        dmn[j] = __ldg(dm_p + (size_t)min(max(k + Q + W - j, 0), n - 2) * a.B);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = x[c] - m[c];
        acc = fmaf(d, d, acc);
      }
      const float rw = k < n && acc != 0.f ? rsqrtf(acc) : 0.f;
#pragma unroll
      for (int j = 0; j < W2; ++j) {
        const int t = k + W - j;  // band slot j of DP row t + 1
        const float dot = dot_row(tp + min(max(t, 0), n - 2) * C, x);
        const float cost = 1.f - (dot - dm[j]) * rw;
        int row = base - j;  // t % R
        if (row < 0) row += R;
        if (t >= 0 && t <= n - 2) ring_lane[(row * W2 + j) * LANES] = cost;
      }
    }
    __syncthreads();
  }
}

cudaError_t launch(const Args& a, int pair0, int npairs, bool gated, cudaStream_t st) {
  static SmemOptIn opt_in;
  const cudaError_t attr = opt_in(score_pairs_v3, RING_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)npairs, (unsigned)((a.B + LANES - 1) / LANES));
  score_pairs_v3<<<grid, dim3(LANES, WARPS), RING_BYTES, st>>>(a, pair0, gated);
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
