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
// Three forms, chosen at compile time from the band and C (RP_W, RP_C)
// alone; each is a template over the band that only its own launcher
// instantiates, so a build compiles one kernel. All take the same arguments
// and compute the same function.
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
// The column form (W_MAX < w, while CF_RS >= 1: w <= 75 at C = 16, 91 at
// C = 8), for the bands whose cost rings would not fit. Its bound is the
// ring form's: operations (0.109 ms at w = 21 at the bench shapes). What
// held back the row form it replaces there (one thread per (stream, pair)
// that loaded each band cell's window column with C scalar loads and made
// its rwn again, 2w times per column: 14x its bound) it does once:
//   - a block is CF_STREAMS consecutive streams by up to MAX_JOBS = 8 pairs,
//     one thread per (stream, pair) (tid = pair slot * CF_STREAMS + stream;
//     at 16 streams a warp holds 2 pairs of the same streams); more than 8
//     pairs take a second block row (blockIdx.y). Threads with b >= B copy
//     stream B - 1 and store nothing; threads with p >= P score nothing.
//   - the block stages each window column once, K5's way (fused_dtw_v1.cu):
//     a shared ring of CF_SLOTS = 2w + 2RS - 1 column slots, chunk-major
//     [slot][C/4][streams][4] (C % 4 == 0, else [slot][C][streams]), read by
//     LDS.128 (a quarter-warp reads 128 contiguous bytes: no bank
//     conflicts); column col lives in slot (col + w) mod CF_SLOTS, counted
//     incrementally. A slot holds window column clip(col, 0, Lm - 1). The
//     copies are 4-byte cp.async, coalesced over the streams: the next
//     step's RS columns go into the RS spare slots right after a step's
//     barrier, behind the step's arithmetic, and are waited for before the
//     next barrier (cp.async.wait_all). One barrier per step.
//   - each pair-thread makes the rwn of each column entering the ring once,
//     from its own mean, into its own entry of a shared rwn ring [slot][8
//     pairs][streams] (read back only by the same thread: no barrier).
//   - a step takes RS DP rows: their T' rows (warp-uniform __ldg, a float4
//     per 4 values) and dotms stay in registers, and the step walks the
//     CF_SPAN = 2w + RS - 1 ring columns once; each column's C values and
//     rwn are read once and feed the dots of the RS rows whose band holds
//     it, so a column is read once per RS rows, not once per cell.
//   - the DP frontier is one array of 2w registers, updated in place in a
//     wavefront: at span column i, row k takes band slot j = i - k, k in
//     order, so that it finds row k - 1's slots j and j + 1 and its own slot
//     j - 1 in the array. Each row's left-to-right chain stays serial, in
//     the reference's order; no cost array is kept, so the registers grow
//     as 2w + (RS + 3) C, not 2w (RS + 1). The step is branch-free: every
//     dot is computed, and a cell outside 1 <= cdp <= n takes +inf by a
//     select; rows past the pair's n - 1 in its last step compute and are
//     never read (the similarity is taken by a select at row n - 1).
//   - RS = 5, fewer where 2w + (RS + 3) C would pass CF_REGS = 214 (at
//     C = 8, 224 spilled); CF_STREAMS = 32 while a ring of 32 streams fits
//     the opt-in with 2 rows per step (fewer rows where it holds no more),
//     else 16. At C = 16: 32 streams with RS = 5 from w = 20, 4 from 34, 3
//     from 35, 2 from 36; 16 streams with RS = 5 from 37, 4 from 44, 3 from
//     52, 2 from 60, 1 from 68 to 75. Past the band where one row passes
//     CF_REGS, the row form takes over. A block of 32 streams is one pair
//     per warp, and a launch at B = 8192 is 256 blocks, one per SM at a
//     time (1.94 waves): at w = 21 it took 0.41 ms against 0.66 for 16
//     streams (3 blocks per SM, 1.29 waves), and at w = 35 0.69 against 1.20
//     (1 block of 3 warps per SM); 5 rows per step 4-5 % less than 4 at w =
//     21 and 24, 2 rows 15-50 % more (PERF.md).
//   - the ring and the rwn ring take CF_SLOTS x (C + 8) x 4 B per stream
//     (CF_BYTES, dynamic shared memory, the > 48 KB attribute set once per
//     card: smem.cuh), linear in w where the ring form's grow as w^2.
//
// The row form (w past the column form's limit): one thread per (stream,
// pair) takes the DP rows in order. Row r loads T'[r-1] once and makes its
// dotm; each of its 2w band slots loads its window column (coalesced; an L1
// or L2 hit, since a column serves 2w rows), that column's rwn and the dot,
// then the row takes its DP step. It holds no ring: its state grows as w,
// not w^2, at the price of each column's load and rwn once per row that
// reads it. A block is 32 streams by up to 8 pairs. It replaces an earlier
// form whose 2w x 2w register ring of costs spilled 12 KB at w = 21 and
// read an illegal address at w = 24 and 30 (PERF.md).
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
constexpr int MAX_JOBS = 8;  // the column and row forms' pairs per block
// the column form: DP rows per step that its registers allow (the frontier,
// RS T' rows, m and a column within CF_REGS), at most 5
constexpr int CF_REGS = 214;
constexpr int CF_RS_REGS = (CF_REGS - W2) / C - 3 < 5 ? (CF_REGS - W2) / C - 3 : 5;
constexpr int CF_SLOT = 4 * (C + MAX_JOBS);  // bytes of a column slot and its rwn slot, per stream
// the most DP rows per step whose ring of 2w + 2RS - 1 slots fits the opt-in, at 32 and 16 streams
constexpr int CF_FIT32 = (SMEM_OPTIN / (32 * CF_SLOT) - W2 + 1) / 2;
constexpr int CF_FIT16 = (SMEM_OPTIN / (16 * CF_SLOT) - W2 + 1) / 2;
// streams per block: 32 while their ring fits 2 rows per step (or the one row the registers allow)
constexpr int CF_STREAMS = CF_FIT32 >= (CF_RS_REGS < 2 ? CF_RS_REGS : 2) ? 32 : 16;
constexpr int CF_RS_FIT = CF_STREAMS == 32 ? CF_FIT32 : CF_FIT16;
constexpr int CF_RS_MOST = CF_RS_REGS < CF_RS_FIT ? CF_RS_REGS : CF_RS_FIT;
constexpr bool COLUMN_FORM = !RING_FORM && CF_RS_MOST >= 1;  // else the row form, past the limit
constexpr int CF_RS = CF_RS_MOST >= 1 ? CF_RS_MOST : 1;  // DP rows per step
constexpr int CF_SPAN = W2 + CF_RS - 1;     // window columns a step reads
constexpr int CF_SLOTS = CF_SPAN + CF_RS;   // and the next step's new ones
constexpr int CF_BYTES = CF_SLOTS * CF_SLOT * CF_STREAMS;
constexpr int SMEM_BYTES = RING_FORM ? RING_BYTES : COLUMN_FORM ? CF_BYTES : 0;
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(!RING_FORM || RING_BYTES <= SMEM_OPTIN,
              "W_MAX = 19 is the largest band whose rings fit the shared-memory opt-in");
static_assert(!COLUMN_FORM || CF_BYTES <= SMEM_OPTIN, "the column form's rings pass the opt-in");

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

// ------------------------------------------------------------ the column form

// 4 bytes from src to the shared-memory address dst, asynchronously
__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int cf_wrap(int s) { return s >= CF_SLOTS ? s - CF_SLOTS : s; }

// Window column clip(col, 0, Lm - 1) of the block's streams into ring slot
// s, copied by all the block's threads: thread i takes coefficient i / S of
// stream i % S (coalesced over the streams), into the chunk-major layout
// where C % 4 == 0. Streams past B copy stream B - 1.
__device__ __forceinline__ void cf_stage(unsigned ring, const Args& a, int col, int s, int b0,
                                         int tid, int nthreads) {
  constexpr int S = CF_STREAMS;
  const float* src = a.win + (size_t)min(max(col, 0), a.Lm - 1) * C * a.B;
  for (int i = tid; i < C * S; i += nthreads) {
    const int c = i / S, lane = i % S;
    const int at = C % 4 == 0 ? (c / 4 * S + lane) * 4 + c % 4 : c * S + lane;
    copy4(ring + 4 * (s * C * S + at), src + (size_t)c * a.B + min(b0 + lane, a.B - 1));
  }
}

// Stream sl's C values of the column in ring slot s: C/4 LDS.128 in the
// chunk-major layout, else C LDS.32.
__device__ __forceinline__ void cf_read(const float* ring, int s, int sl, float (&x)[C]) {
  constexpr int S = CF_STREAMS;
  const float* col = ring + s * C * S;
  if constexpr (C % 4 == 0) {
    const float4* q4 = reinterpret_cast<const float4*>(col) + sl;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 f = q4[q * S];
      x[4 * q] = f.x; x[4 * q + 1] = f.y; x[4 * q + 2] = f.z; x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = col[c * S + sl];
  }
}

// rsqrt(|W - m|^2) of the column in slot s, 0 for a zero norm.
__device__ __forceinline__ float cf_rwn(const float* ring, int s, int sl, const float (&m)[C]) {
  float x[C];
  cf_read(ring, s, sl, x);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = x[c] - m[c];
    acc = fmaf(d, d, acc);
  }
  return acc != 0.f ? rsqrtf(acc) : 0.f;
}

template <int BW>
__global__ void __launch_bounds__(CF_STREAMS * MAX_JOBS) score_pairs_v2_cols(Args a) {
  static_assert(BW == W && COLUMN_FORM, "instantiated at the build's band, in the column form");
  constexpr int S = CF_STREAMS, RS = CF_RS, STRIDE = MAX_JOBS * S;
  extern __shared__ float4 smem4[];  // the column ring [CF_SLOTS][C][S], then the rwn ring
  float* ring = reinterpret_cast<float*>(smem4);
  const unsigned ring_at = (unsigned)__cvta_generic_to_shared(ring);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int sl = tid % S, ty = tid / S;
  const int jy = nthreads / S;
  const int b0 = blockIdx.x * S;
  const int b = b0 + sl;
  const int p = blockIdx.y * jy + ty;
  const bool live = b < a.B && p < a.P;
  const int n = p < a.P ? a.lens[p] : 0;  // 1 <= n <= Lm for real pairs
  // rows of the longest pair of this block: the loop, and so the barriers,
  // are the same for every thread
  int nmax = 0;
  for (int q = blockIdx.y * jy; q < min(a.P, (blockIdx.y + 1) * jy); ++q)
    nmax = max(nmax, a.lens[q]);
  const int pc = min(p, a.P - 1), bl = min(b, a.B - 1);
  float m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = __ldg(a.means + ((size_t)pc * C + c) * a.B + bl);
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)pc * (a.Lm + W2) + W) * C;
  float* rwn = ring + CF_SLOTS * C * S + ty * S + sl;  // this thread's entry of slot s: rwn[s * STRIDE]

  // the first step's span, columns -W ... W+RS-2, into slots 0 ... CF_SPAN-1
  for (int s = 0; s < CF_SPAN; ++s) cf_stage(ring_at, a, s - W, s, b0, tid, nthreads);
  copies_done();
  __syncthreads();
  for (int s = 0; s < CF_SPAN; ++s) rwn[s * STRIDE] = cf_rwn(ring, s, sl, m);

  float F[W2];  // the DP frontier, updated in place
#pragma unroll
  for (int j = 0; j < W2; ++j) F[j] = j == W ? 0.f : INFINITY;
  float result = INFINITY;

  int base = 0;  // the slot of column r0 - W - 1, the step's first band column
  for (int r0 = 1; r0 < nmax; r0 += RS) {
    const int next = cf_wrap(base + RS);
    const bool more = r0 + RS < nmax;
    // the next step's new columns r0+RS+W-2 ... into the spare slots, which
    // every thread last read in the step before this one
    if (more) {
#pragma unroll
      for (int k = 0; k < RS; ++k)
        cf_stage(ring_at, a, r0 + RS + W - 2 + k, cf_wrap(next + W2 - 1 + k), b0, tid, nthreads);
    }
    if (r0 < n) {
      float t[RS][C], dotm[RS];
#pragma unroll
      for (int k = 0; k < RS; ++k) {
        load_row(tp + (r0 - 1 + k) * C, t[k]);
        dotm[k] = dot(t[k], m);
      }
      // span column i holds band slot j = i - k of row r0 + k
      int s = base;
#pragma unroll
      for (int i = 0; i < CF_SPAN; ++i, s = s + 1 == CF_SLOTS ? 0 : s + 1) {
        float x[C];
        cf_read(ring, s, sl, x);
        const float rw = rwn[s * STRIDE];
#pragma unroll
        for (int k = 0; k < RS; ++k) {
          const int j = i - k;
          if (j < 0 || j >= W2) continue;  // compile-time
          const int cdp = r0 + k - W + j;  // DP column; window column cdp - 1
          const float cell = fmaf(-(dot(t[k], x) - dotm[k]), rw, 1.f);  // 1 - (dot - dotm) rw
          const float cost = cdp >= 1 && cdp <= n ? cell : INFINITY;  // <= r + W - 1 always holds
          // F[j], F[j + 1]: row r0+k-1's; F[j - 1]: this row's
          const float ins = j + 1 < W2 ? F[j + 1] : INFINITY;
          float v = cost + fminf(ins, F[j]);
          if (j > 0) v = fminf(v, cost + F[j - 1]);
          F[j] = v;
          if (j == W + 1) result = r0 + k == n - 1 ? v : result;
        }
      }
    }
    copies_done();
    __syncthreads();
    if (more) {
#pragma unroll
      for (int k = 0; k < RS; ++k) {
        const int s = cf_wrap(next + W2 - 1 + k);
        rwn[s * STRIDE] = cf_rwn(ring, s, sl, m);
      }
    }
    base = next;
  }
  if (live) a.out[(size_t)p * a.B + b] = result;
}

// ------------------------------------------------------------ the row form

template <int BW>
__global__ void __launch_bounds__(LANES * MAX_JOBS) score_pairs_v2_rows(Args a) {
  static_assert(BW == W && !RING_FORM && !COLUMN_FORM,
                "instantiated at the build's band, in the row form");
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

// A template, so that the forms not taken are not instantiated.
template <bool Ring, bool Column>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if constexpr (Ring) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(score_pairs_v2<W>, SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)a.P, (unsigned)((a.B + LANES - 1) / LANES));
    score_pairs_v2<W><<<grid, dim3(LANES, WARPS), SMEM_BYTES, st>>>(a);
  } else if constexpr (Column) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(score_pairs_v2_cols<W>, SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
    const int jy = a.P < MAX_JOBS ? a.P : MAX_JOBS;
    const dim3 grid((unsigned)((a.B + CF_STREAMS - 1) / CF_STREAMS), (unsigned)((a.P + jy - 1) / jy));
    score_pairs_v2_cols<W><<<grid, CF_STREAMS * jy, SMEM_BYTES, st>>>(a);
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
  return (int)launch<RING_FORM, COLUMN_FORM>(a, static_cast<cudaStream_t>(stream));
}
