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
// Layout (all fp32 unless noted, stream index b innermost, so a warp's 32
// consecutive streams read 128 contiguous bytes):
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
// Two forms, chosen at compile time from the band (RP_W) alone; each is a
// template over the band that only its own launcher instantiates, so a build
// compiles one kernel. Both take the same arguments and compute the same
// function.
//
// The ring form (w <= W_MAX = 19), K2's (csrc/fused_dtw_v3.cu) with no gate
// and a linear window:
//   - a block is 32 consecutive streams (threadIdx.x, one per lane) by
//     WARPS = Q + 1 = 5 warps (threadIdx.y) of one pair; the pair is the
//     fastest grid index, so that the blocks of one group of streams run
//     side by side and read its window columns from L2 once. One launch.
//   - round u: producer warp q (1 ... Q) takes column k = u*Q + q - 1 whole:
//     its C values (a coalesced load, prefetched one round ahead), rwn(k) =
//     rsqrt(|W[k] - m|^2) (0 where the squared norm is 0 or k >= n), and the
//     2w band costs of the column, cost(t, j) = 1 - (T'[t].W[k] - dotm[t]) *
//     rwn(k) for the template rows t = k + w - j whose DP row t + 1 holds it
//     at band slot j (each dot one fp32 FMA chain over c, in order). It
//     stores them in the cost ring, laid out [row t mod R][slot j][lane] so
//     that every store and load of a warp is one conflict-free wavefront.
//     One __syncthreads per round; then warp 0 takes the DP steps of the Q
//     rows that the round completes (row t is whole after column t + w - 1),
//     reading 2w costs per row, while the producers run the next round.
//   - dotm[t] = T'[t].m is computed here, as the TPU kernel's pre-pass does:
//     once per (stream, pair, template row), an fp32 FMA chain over c in
//     order, into a shared dotm ring [row t mod R][lane]. Column k reads rows
//     k - w + 1 ... k + w, which other producers of the same round also read,
//     so each row is made a round ahead: in round u producer q makes row
//     k + w + Q, the newest row of its next column, and a prologue makes rows
//     -w + 1 ... Q - 1 + w (round 0's) before the first barrier. Rows outside
//     0 ... n - 2 are made of a clamped row and never stored as a cost.
//   - the rings: row t's cost slot j is written in the round of column
//     t - w + j and read in the round of column t + w - 1, and row t + R
//     writes the same slot while warp 0 may still run the round before it;
//     row t's dotm is last read in column t + w - 1 and its slot rewritten in
//     column t + R - Q - w, and the reads of a round race with its writes.
//     Both hold, whatever the row's place in its round, when R >= 2w + 2Q - 1
//     (tests/test_torch_k4_schedule.py runs every round's writes before the
//     reads they could overtake; 2w + 2Q - 2 rows fail it, for either ring).
//     At w = 5 the two rings are 17 x 11 x 32 floats, 23,936 B per block
//     (dynamic shared memory); they grow as w^2. W_MAX = 19 is the largest
//     band whose rings fit sm_90's 227 KB opt-in with Q = 4. Ring rows are
//     counted incrementally: no run-time modulo.
//   - the producer's column step is branch-free: the dot chains are
//     unguarded, with clamped rows, and only the cost stores are predicated,
//     so that the compiler schedules them as one basic block; rwn is rsqrtf
//     (2 ulp). A guard per chain made each its own basic block and cost K1
//     1.3x (PERF.md). C and w are compile-time: -DRP_C, -DRP_W.
//   - T' rows are warp-uniform __ldg loads. Staging the pair's T' in shared
//     memory measured 15 % faster at w = 5 and 5 % slower at w = 19, and its
//     bytes grow with Lm past the opt-in at w = 19 (PERF.md): not taken.
//
// The row form (w > W_MAX), for the bands whose shared rings would not fit:
// one thread per (stream, pair) takes the DP rows in order. Row r loads
// T'[r-1] once and makes its dotm; each of its 2w band slots loads its window
// column (coalesced; an L1 or L2 hit, since a column serves 2w rows), that
// column's rwn and the dot, then the row takes its DP step. It holds no ring:
// its state grows as w, not w^2, at the price of each column's load and rwn
// once per row that reads it. A block is 32 streams by up to 8 pairs. It
// replaces an earlier form whose 2w x 2w register ring of costs spilled
// 12 KB at w = 21 and read an illegal address at w = 24 and 30 (PERF.md).
//
// DP recurrence, as the reference: new_j = cost_j + min(prev_{j+1}, prev_j),
// then strictly left to right new_j = min(new_j, cost_j + new_{j-1}); a cell
// is valid iff 1 <= r - w + j <= min(n, r + w - 1), else +inf; the similarity
// is slot w+1 of row n-1 (the padded [m-1][n] cell).
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
constexpr int LANES = 32;  // streams per block
constexpr int W_MAX = 19;  // the ring form's largest band
constexpr bool RING_FORM = W <= W_MAX;
constexpr int Q = 4;               // the ring form's producer warps: columns per round
constexpr int WARPS = Q + 1;       // and the DP warp
constexpr int R = W2 + 2 * Q - 1;  // rows of the cost ring and of the dotm ring
constexpr int RING_BYTES = 4 * R * (W2 + 1) * LANES;
constexpr int SMEM_BYTES = RING_FORM ? RING_BYTES : 0;
constexpr int MAX_JOBS = 8;  // the row form's pairs per block
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(!RING_FORM || RING_BYTES <= SMEM_OPTIN,
              "W_MAX = 19 is the largest band whose rings fit the shared-memory opt-in");

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
  for (int c = 0; c < C; ++c) x[c] = __ldg(p + (size_t)c * B);
}

// A warp-uniform T' row t into registers.
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

// v[0]*x[0] + ... as one fp32 FMA chain.
__device__ __forceinline__ float dot(const float (&v)[C], const float (&x)[C]) {
  float acc = v[0] * x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = fmaf(v[c], x[c], acc);
  return acc;
}

__device__ __forceinline__ float dot_row(const float* t, const float (&x)[C]) {
  float v[C];
  load_row(t, v);
  return dot(v, x);
}

// ------------------------------------------------------------ the ring form

// Template row t clamped into 0 ... n - 2, the rows a DP of length n reads.
__device__ __forceinline__ int clamp_row(int t, int n) { return min(max(t, 0), n - 2); }

template <int BW>
__global__ void __launch_bounds__(LANES * WARPS) score_pairs_v2(Args a) {
  static_assert(BW == W && RING_FORM, "instantiated at the build's band, in the ring form");
  extern __shared__ float smem[];  // the cost ring [R][W2][LANES], then the dotm ring [R][LANES]
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int p = blockIdx.x;
  const int b = blockIdx.y * LANES + lane;
  const bool live = b < a.B;
  const int bl = live ? b : a.B - 1;  // threads past B load stream B-1
  const size_t o = (size_t)p * a.B + b;
  const int n = a.lens[p];  // 1 <= n <= Lm, the same for the whole block
  if (n < 2) {
    if (live && g == 0) a.out[o] = INFINITY;
    return;
  }
  float* costs = smem + lane;
  float* dotm = smem + R * W2 * LANES + lane;
  const int kend = n + W - 2;  // DP row n-1 is whole after column n + W - 3
  const int rounds = (kend + Q - 1) / Q;

  if (g == 0) {
    // the DP warp: rows t = u*Q - W + 1 ... u*Q + Q - W in round u
    float prev[W2];
#pragma unroll
    for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
    int t = -W + 1;
    int row = R - W + 1;  // t % R
    __syncthreads();      // the producers' dotm prologue
    for (int u = 0; u < rounds; ++u) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Q; ++i, ++t, row = row + 1 == R ? 0 : row + 1) {
        if (t < 0 || t > n - 2) continue;
        const int r = t + 1;
        const int hi = min(n, r + W - 1);
        const float* rp = costs + row * W2 * LANES;
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
    if (live) a.out[o] = prev[W + 1];
    return;
  }

  // a producer warp: column k = u*Q + g - 1 in round u
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  float m[C];
  load_column(a.means + (size_t)p * C * a.B + bl, a.B, m);
  // the dotm prologue: rows -W+1 ... Q-1+W, those of round 0's columns
  for (int t = -W + g; t <= Q - 1 + W; t += Q)
    dotm[(t + R) % R * LANES] = dot_row(tp + clamp_row(t, n) * C, m);
  __syncthreads();
  int k = g - 1;
  float nxt[C];  // column k, loaded a round ahead
  load_column(a.win + (size_t)min(k, n - 1) * C * a.B + bl, a.B, nxt);
  int base = (k + W) % R;  // the ring row of template row k + W (band slot 0)
  for (int u = 0; u < rounds; ++u, k += Q, base = base + Q >= R ? base + Q - R : base + Q) {
    if (k < kend) {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = nxt[c];
      // the next round's column, clamped into range
      load_column(a.win + (size_t)min(k + Q, n - 1) * C * a.B + bl, a.B, nxt);
      // the newest dotm row of the next round's column: k + Q + W
      const int next = base + Q >= R ? base + Q - R : base + Q;
      dotm[next * LANES] = dot_row(tp + clamp_row(k + Q + W, n) * C, m);
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
        int row = base - j;       // t % R
        if (row < 0) row += R;
        const float dot = dot_row(tp + clamp_row(t, n) * C, x);
        const float cost = 1.f - (dot - dotm[row * LANES]) * rw;
        if (t >= 0 && t <= n - 2) costs[(row * W2 + j) * LANES] = cost;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ the row form

template <int BW>
__global__ void __launch_bounds__(LANES * MAX_JOBS) score_pairs_v2_rows(Args a) {
  static_assert(BW == W && !RING_FORM, "instantiated at the build's band, in the row form");
  const int b = blockIdx.x * LANES + threadIdx.x;
  const int p = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= a.B || p >= a.P) return;
  const size_t o = (size_t)p * a.B + b;
  const int n = a.lens[p];  // 1 <= n <= Lm
  if (n < 2) {
    a.out[o] = INFINITY;
    return;
  }
  float m[C];
  load_column(a.means + (size_t)p * C * a.B + b, a.B, m);
  // T' row t of pair p is at tp + t * C
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  const float* col = a.win + b;  // window column c at col + c * C * B
  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  for (int r = 1; r < n; ++r) {
    float t[C];  // T'[r - 1]
    load_row(tp + (r - 1) * C, t);
    const float dm = dot(t, m);
    const int hi = min(n, r + W - 1);
    float cost[W2], cur[W2];
#pragma unroll
    for (int j = 0; j < W2; ++j) {
      const int cdp = r - W + j;  // window column cdp - 1, clamped into 0 ... n-1
      float x[C];
      load_column(col + (size_t)min(max(cdp - 1, 0), n - 1) * C * a.B, a.B, x);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = x[c] - m[c];
        acc = fmaf(d, d, acc);
      }
      const float rw = acc != 0.f ? rsqrtf(acc) : 0.f;
      cost[j] = cdp >= 1 && cdp <= hi ? 1.f - (dot(t, x) - dm) * rw : INFINITY;
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
  a.out[o] = prev[W + 1];
}

// A template, so that the form not taken is not instantiated.
template <bool Ring>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if constexpr (Ring) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(score_pairs_v2<W>, SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)a.P, (unsigned)((a.B + LANES - 1) / LANES));
    score_pairs_v2<W><<<grid, dim3(LANES, WARPS), SMEM_BYTES, st>>>(a);
  } else {
    const int jy = a.P < MAX_JOBS ? a.P : MAX_JOBS;
    const dim3 grid((unsigned)((a.B + LANES - 1) / LANES), (unsigned)((a.P + jy - 1) / jy));
    score_pairs_v2_rows<W><<<grid, dim3(LANES, jy), 0, st>>>(a);
  }
  return cudaGetLastError();
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
  return (int)launch<RING_FORM>(a, static_cast<cudaStream_t>(stream));
}
