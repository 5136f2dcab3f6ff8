// K1: the whole-chunk fused band-cost + banded-DTW scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel rustpotter_tpu/ops/fused_dtw.py::_kernel_v4 (driven
// by fused_dtw_chunk_v4_tiled). It computes the function of
// rustpotter_tpu_torch.ops.fused_dtw.fused_dtw_chunk_v4_ref: for every stream b,
// MFCC shift s of the 30 ms chunk and template pair p, the banded-DTW
// similarity of the pre-normalized template T'_p against the CMN-normalized
// VIRTUAL window of shift s (the pre-chunk circular window plus the s+1 new
// rows), with each wakeword's avg pair gating its template pairs.
//
// Layout (all fp32 unless noted, stream index b innermost, so a warp's 32
// consecutive streams read 128 contiguous bytes):
//   win   (F, C, B)          circular window before the chunk, cursor *rot0 (i32)
//   newr  (3, C, B)          the chunk's 3 new MFCC rows
//   means (3, P, C, B)       per-shift CMN means of every pair
//   tpl   (P, W + Lm + W, C) T' = T * rsqrt(|T|^2), zero rows kept at zero,
//                            with W zero rows of padding before and after
//   lens  (P,) i32           pair lengths n; gate (D,) sim-domain avg-gate bounds
//   out   (3, P, B)          similarities (the wrapper returns the (B, 3, P) view)
// Pair order: p = d*K + k for templates, then D*K + d for the avg pairs.
//
// One pass over the columns serves all 3 shifts. Shift s+1's virtual window
// is shift s's moved by one column, so the three windows are slices of one
// extended sequence E: E[k] is shift 0's logical column k (k = 0 ... n+1),
// and shift s's logical column i is E[i + s]. The dot T'[t].E[k] does not
// depend on the CMN mean, so each column of E is loaded once and dotted with
// the 2w+2 template rows t = k-w-1 ... k+w that some shift's band holds
// (shift s needs t = k-s-w+1 ... k-s+w). Only these are per shift:
// rwn_s(k) = 1/|E[k] - m_s|, dotm_s[t] = T'[t].m_s, the mean correction
// cost = 1 - (dot - dotm_s[t]) * rwn_s(k), and the DP. Shift s's DP row
// r = t+1 is whole after column k = t + w - 1 + s, so the three DPs run one
// column apart; its band slot j reads the dot of row t and column
// t - w + j + s, that is diagonal u = k - t + w = j + s of row t.
//
// Bound at the bench shapes (B=8192, P=6, Lm=F=100, C=16, w=5, gate open):
// the function needs 3.8724 GFLOP per chunk (utils/profiling.py k1_work: the
// dots once per distinct column over the 3 shifts, 1.7726; rwn, dotm, mean
// correction and DP per shift, 2.0998), 0.0578 ms at the H100 SXM's 67
// TFLOP/s fp32 (non-tensor) peak. Its bytes (window 52 MB, means 9.4 MB, new
// rows and output) are ~64 MB, ~19 us at 3.35 TB/s: bound by operations
// (chip_smoke.py computes both from its inputs). Tensor cores are no help:
// the port is true fp32 and wgmma has no fp32 form. Counted from the design
// (utils/profiling.py k1_executed; not measured on the card), it executes
// 4.0924 GFLOP per chunk there: each of the n+w column steps computes dotm,
// rwn and 3*NR dots, unguarded, and each DP step corrects all 2w band slots.
// The one-thread-per-(shift, pair) design before it executed ~6.5.
//
// Design:
//   - three threads per (stream, pair), one per shift: a block is 32
//     consecutive streams (threadIdx.x, a warp) by the 3 shifts
//     (threadIdx.y) of one pair (blockIdx.y). For column k each thread takes
//     E[k] from registers (loaded during column k-1: the three warps read
//     the same 128-byte lines, L1 hits), computes the dotm of the row its
//     DP completes at column k, its shift's rwn_s(k) into a register ring
//     of 2w, and NR = ceil((2w+2)/3) of the column's 2w+2 dots (rows
//     k-w-1+idx, idx = s*NR ... s*NR+NR-1, each one fp32 FMA chain over c,
//     in order), which it writes to a ring in shared memory; one
//     __syncthreads; then its shift's DP step, reading the 2w dots of its row
//     from the ring. Splitting by shift gives 3x the threads of one thread
//     per (stream, pair) and keeps the avg launch (1/6 of the pairs) at 3
//     warps per 32 streams.
//   - the column step is branch-free: every chain in it (dotm, rwn, the NR
//     dots, the next column's loads) is independent and unguarded, with
//     clamped row and column indices, so that the compiler schedules them
//     as one basic block and the warp overlaps their latencies; only the
//     ring stores are predicated, and the DP step after the barrier is the
//     one branch. At the bench shapes the avg launch has 2 blocks (6 warps)
//     per SM and each warp's chain of n+w column steps is its time, so the
//     ILP inside the step is what counts: with each dot, dotm and rwn
//     guarded by its own branch (and rwn as an IEEE 1/sqrtf, a call to a
//     slow path) the same work took 1.3x as long (PERF.md, PR 5). rwn is
//     rsqrtf (2 ulp), or 0 where the squared norm is 0.
//   - the dot ring: R = 2w+1 rows (t mod R) x U = 2w+2 diagonals u x 32
//     lanes, laid out [row][u][lane], so that every access of a warp is one
//     conflict-free wavefront: (2w+1)(2w+2)*128 B = 16,896 B per block at
//     w = 5 (dynamic shared memory). Row t's diagonal u is written at column
//     t - w + u and last read by the DP step of column t + w - 1 + min(u, 2)
//     (shift min(u, 2)). Row t + R writes the same slot at column
//     t + R - w + u, before that column's barrier, while a slower thread may
//     still be reading the column before it: so the write must come at least
//     two columns after the last read, R >= 2w + 1 - u + min(u, 2), which is
//     2w + 1 at u <= 2. One barrier per column then suffices
//     (tests/test_torch_k1_schedule.py runs every column's writes before the
//     previous column's reads; 2w rows fail it).
//   - the gate counters: given a pointer `counts` to four int64 counters
//     and two per wakeword slot after them (the port's tracing on; null
//     otherwise), thread (0, 0) of each block of the gated launch adds the
//     block's open lanes, its lanes (32 streams or fewer x 3 shifts), 1 if
//     the block works (a lane open and n >= 2) and 1, by four atomics; the
//     open lanes are the barrier's count (__syncthreads_count, which
//     replaced __syncthreads_or). For wakeword d = p / K below `wslots` it
//     adds the open lanes and the 1 if it works again, at slots 4 + 2d and
//     5 + 2d. With the pointer null no atomic runs and nothing else changes.
//   - the column loop is unrolled by 2w, so that the rwn ring and the DP
//     frontier have compile-time register indices; the shared ring takes
//     run-time ones. C and w are compile-time: -DRP_C, -DRP_W. ptxas at
//     C = 16, w = 5: 168 registers, no spills, 4 blocks (12 warps) per SM;
//     registers, not shared memory, bound the occupancy.
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
constexpr int U = W2 + 2;         // template rows per column = diagonals per row
constexpr int R = W2 + 1;         // rows of the shared dot ring
constexpr int SHIFTS = 3;
constexpr int NR = (U + SHIFTS - 1) / SHIFTS;  // dot rows per shift thread
constexpr int LANES = 32;         // streams per block
constexpr int RING_BYTES = (int)sizeof(float) * R * U * LANES;
static_assert(RING_BYTES <= SMEM_OPTIN, "the ring passes sm_90's shared-memory opt-in");
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");

struct Args {
  const float* win;
  const float* newr;
  const float* means;
  const float* tpl;
  const int* lens;
  const float* gate;
  const int* rot0;
  float* out;
  unsigned long long* counts;  // the gated launch's counters, or null
  int B, F, Lm, D, K, P;
  // the wakewords 0 .. wslots - 1 counted on their own after the four (at
  // most D); last, since placed before B it cost 4 bytes of spill at C = 16
  // (ptxas 12.9)
  int wslots;
};

// Element 0 of column k of the extended sequence E (shift 0's logical
// column k), for stream b; element c is at [c * B]. k <= n + 1 <= F + 1,
// so the new-row index is at most 2. rot is shift 0's cursor (rot0 + 1) % F.
__device__ __forceinline__ const float* ext_column(const Args& a, int rot, int k, int b) {
  const int nj = k - (a.F - 1);
  if (nj >= 0) return a.newr + (size_t)nj * C * a.B + b;
  int ph = rot + 1 + k;  // < 2F: rot < F and k < F - 1
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

// One launch: the 3 shifts of pairs pair0 ... pair0 + gridDim.y - 1.
__global__ void __launch_bounds__(LANES * SHIFTS)
    score_pairs(Args a, int pair0, bool gated) {
  extern __shared__ float dots[];  // the dot ring [R][U][LANES]
  const int lane = threadIdx.x;
  const int s = threadIdx.y;
  const int p = pair0 + blockIdx.y;
  const int b = blockIdx.x * LANES + lane;
  const bool live = b < a.B;
  const int bl = live ? b : a.B - 1;  // threads past B load stream B-1
  const size_t o = (size_t)(s * a.P + p) * a.B + b;
  const int n = a.lens[p];  // 1 <= n <= Lm
  bool open = live;
  const int d = gated ? p / a.K : 0;  // the template pair's wakeword
  if (gated && live) {
    // a NaN avg similarity keeps the gate closed, as the TPU kernel's compare
    open = a.out[(size_t)(s * a.P + a.D * a.K + d) * a.B + b] <= a.gate[d];
  }
  const int nopen = __syncthreads_count(open);
  if (gated && a.counts != nullptr && lane == 0 && s == 0) {
    const bool works = n >= 2 && nopen > 0;
    atomicAdd(a.counts, (unsigned long long)nopen);
    atomicAdd(a.counts + 1, (unsigned long long)(SHIFTS * min(LANES, a.B - (int)blockIdx.x * LANES)));
    if (works) atomicAdd(a.counts + 2, 1ull);
    atomicAdd(a.counts + 3, 1ull);
    if (d < a.wslots) {
      atomicAdd(a.counts + 4 + 2 * d, (unsigned long long)nopen);
      if (works) atomicAdd(a.counts + 5 + 2 * d, 1ull);
    }
  }
  if (n < 2 || nopen == 0) {
    if (live) a.out[o] = INFINITY;
    return;
  }
  const bool dp_warp = __any_sync(0xffffffffu, open);

  float m[C];
  load_column(a.means + (size_t)(s * a.P + p) * C * a.B + bl, a.B, m);
  // T' row t of pair p is at tp + t * C for -W <= t < Lm + W
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  int rot = *a.rot0 + 1;
  if (rot >= a.F) rot -= a.F;

  float rw[W2];  // rw[ring(k)] = rwn_s(k) of the last 2w columns
  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) {
    rw[j] = 0.f;
    prev[j] = j == W ? 0.f : INFINITY;
  }
  float* ring_lane = dots + lane;
  float nxt[C];
  load_column(ext_column(a, rot, 0, bl), a.B, nxt);
  const int klast = n + 1;  // the last column of E that shift 2 reads
  const int kend = n + W;   // shift 2's row n-1 is whole after column n + W - 1
  for (int k0 = 0; k0 < kend; k0 += W2) {
#pragma unroll
    for (int q = 0; q < W2; ++q) {
      const int k = k0 + q;  // k0 % W2 == 0, so ring(k + x) == ring(q + x)
      if (k >= kend) break;
      const int t = k - W + 1 - s;  // this shift's DP row r = t + 1 is whole after column k
      const bool step = dp_warp && t >= 0 && t <= n - 2;
      // column k, branch-free: the rows and the next column are clamped into
      // range, and what they give outside it is never stored or used (no
      // valid cell reads a column past klast either, but without that guard
      // ptxas spills 16 bytes at C = 16)
      const int tc = min(max(t, 0), n - 2);
      const float dm = dot_row(tp + tc * C, m);
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = nxt[c];
      load_column(ext_column(a, rot, min(k + 1, klast), bl), a.B, nxt);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = x[c] - m[c];
        acc = fmaf(d, d, acc);
      }
      // column k is this shift's column k - s
      const bool mine = k >= s && k - s < n && acc != 0.f;
      const float rv = mine ? rsqrtf(acc) : 0.f;
      float dv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int tr = k - W - 1 + s * NR + i;  // row k - W - 1 + idx, idx = s * NR + i
        dv[i] = dot_row(tp + min(max(tr, 0), n - 2) * C, x);
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int idx = s * NR + i;  // diagonal U - 1 - idx of row tr
        const int tr = k - W - 1 + idx;
        if (idx < U && tr >= 0 && tr <= n - 2 && k <= klast)
          ring_lane[((tr % R) * U + (U - 1 - idx)) * LANES] = dv[i];
      }
      rw[q] = rv;
      __syncthreads();
      if (step) {
        const int r = t + 1;
        const int hi = min(n, r + W - 1);
        const float* row = ring_lane + ((t % R) * U + s) * LANES;  // diagonals s ... s+2w-1
        float cost[W2], cur[W2];
#pragma unroll
        for (int j = 0; j < W2; ++j) {
          // band slot j: column t - W + j + s of E, whose rwn is rw[ring(k - 2W + 1 + j)]
          const int cdp = r - W + j;
          const float c = 1.f - (row[j * LANES] - dm) * rw[ring(q + 1 + j)];
          cost[j] = cdp >= 1 && cdp <= hi ? c : INFINITY;
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
  if (live) a.out[o] = open ? prev[W + 1] : INFINITY;
}

cudaError_t launch(const Args& a, int pair0, int npairs, bool gated, cudaStream_t st) {
  static SmemOptIn opt_in;
  const cudaError_t attr = opt_in(score_pairs, RING_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((a.B + LANES - 1) / LANES), (unsigned)npairs);
  score_pairs<<<grid, dim3(LANES, SHIFTS), RING_BYTES, st>>>(a, pair0, gated);
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream`. Returns cudaGetLastError() after the launches: a
// refused launch (bad grid, too many resources) never runs, so the caller
// must check this value.
// `counts`: 4 + 2 * wslots int64 counters on the card that the gated launch
// adds to (see the design above), or null; `wslots`: the wakewords it counts
// on their own, 0 .. min(D, wslots) - 1.
extern "C" int rp_fused_dtw_v4(const void* win, const void* newr,
                               const void* means, const void* tpl,
                               const void* lens, const void* gate,
                               const void* rot0, void* out, void* counts,
                               void* stream, int wslots, int B, int F, int Lm, int D,
                               int K) {
  const Args a{static_cast<const float*>(win),  static_cast<const float*>(newr),
               static_cast<const float*>(means), static_cast<const float*>(tpl),
               static_cast<const int*>(lens),    static_cast<const float*>(gate),
               static_cast<const int*>(rot0),    static_cast<float*>(out),
               static_cast<unsigned long long*>(counts),
               B, F, Lm, D, K, D * K + D, wslots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(a, D * K, D, false, st);
  if (err != cudaSuccess || D * K == 0) return (int)err;
  return (int)launch(a, 0, D * K, true, st);
}
