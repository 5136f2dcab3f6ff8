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
// depend on the CMN mean, so each column of E is dotted once with the 2w+2
// template rows t = k-w-1 ... k+w that some shift's band holds (shift s
// needs t = k-s-w+1 ... k-s+w). Only these are per shift: rwn_s(k) =
// 1/|E[k] - m_s|, dotm_s[t] = T'[t].m_s, the mean correction cost = 1 -
// (dot - dotm_s[t]) * rwn_s(k), and the DP. Shift s's DP row r = t+1 is
// whole after column k = t + w - 1 + s, so the three DPs run one column
// apart; its band slot j reads the dot of row t and column t - w + j + s,
// that is diagonal u = k - t + w = j + s of row t.
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
// 4.1233 GFLOP per chunk there: each of the ceil((n+w)/2) steps of two
// columns computes two dotm, two rwn and 2*NR dots, unguarded (an odd n+w
// computes one column past the end), and each DP step corrects all 2w band
// slots.
//
// Design:
//   - three threads per (stream, pair), one per shift: a block is 32
//     consecutive streams (threadIdx.x, a warp) by the 3 shifts
//     (threadIdx.y) of one pair (blockIdx.y). Splitting by shift gives 3x
//     the threads of one thread per (stream, pair) and keeps the avg launch
//     (1/6 of the pairs) at 3 warps per 32 streams.
//   - a step covers two columns of E, k and k+1 (k even), with one
//     __syncthreads. Before it each thread takes both columns from shared
//     memory, computes its shift's dotm of the two rows its DP completes and
//     rwn_s of both columns, and 2*NR dots, NR = ceil((2w+2)/3): the 2w+3
//     rows k-w-1 ... k+w+1 that the two columns need give 4w+4 dots (row
//     k-w-1 meets column k only, row k+w+1 column k+1 only), and shift s
//     takes the NR+1 rows k-w-1+s*NR+i, i = 0 ... NR, loading each T' row
//     once for both columns (dots of column k at i < NR, of column k+1 at
//     i > 0). Each dot is one fp32 FMA chain over c, in order. After it,
//     each thread takes its shift's two DP steps. So a step loads 2w+3 T'
//     rows where two one-column steps loaded 2(2w+2), and meets one barrier
//     where they met two. An odd n+w ends in a step whose second column
//     lies past the last: nothing of it reaches a valid cell.
//   - the step is branch-free before the barrier: every chain in it (dotm,
//     rwn, the dots) is independent and unguarded, with clamped row and
//     column indices, so that the compiler schedules them as one basic
//     block and the warp overlaps their latencies; even the ring stores are
//     unguarded (a row outside [0, n-2] or a column past n+1 lands where no
//     valid cell reads, after the last read of what it replaces). rwn is
//     rsqrtf (2 ulp), or 0 where the squared norm is 0. After the barrier a
//     DP step is one branch, and an interior row (w < r <= n-w+1, every band
//     slot valid) takes a copy of the step without the +inf masks.
//   - E and T' come from shared memory, staged by the shift warps
//     themselves with cp.async (no producer warp: its registers would come
//     from the shift warps). E's two columns of a step are a tile of 2 x C
//     x 32 floats, in a ring of 2 tiles; the copies of step m+1's tile are
//     issued at the start of step m. Where every coefficient row of the
//     block's streams starts 16-byte aligned (B % 4 == 0, aligned window and
//     new rows) each thread copies CHT 16-byte pieces; else 4 bytes a lane
//     (any B). A column past n+1 is clamped to n+1, the window's wrap and
//     the new rows are resolved per column when its copy is issued. T' is a
//     ring of RT = 2w+5 rows, clamped into [0, n-2] when copied, with its
//     first NR rows mirrored after it, so that each thread reads its rows
//     from one base without a wrap: step m reads its 2w+3 rows while the 2
//     rows of step m+1 land. Each thread waits for its own copies
//     (cp.async.wait_all) before the step's barrier, which makes them
//     visible to all. cp.async and not the copy engine: 1-D bulk copies
//     (cp.async.bulk on an mbarrier, one 128-byte row each) took K1 to
//     2.52 ms at the bench shapes, B = 65536, against 1.66 ms this way (an
//     H100, PERF.md). So the column loop issues no load from device memory,
//     and its
//     64-bit address arithmetic is that of the copies alone.
//   - the dot ring: RC = 2w+2 columns (E's column kk in ring column kk mod
//     RC) x U = 2w+2 diagonals u x 32 lanes, laid out [column][u][lane], so
//     that every access of a warp is one conflict-free wavefront: 18,432 B
//     at w = 5. Row t's diagonal u, that of column t - w + u, is written in
//     that column's step. Shift s reads band slot j of its DP at column kd =
//     t + w - 1 + s from diagonal s + j of column kd - 2w + 1 + j. A step's
//     loop unrolls by UNR = w + 1 steps, RC columns, so every column index
//     is a compile-time constant, and a thread's diagonals add a constant
//     per shift: no ring index is computed at run time. With two columns per
//     barrier, a thread may store step m+1's dots while a slower one still
//     takes step m's DP, so a slot read after a barrier must be written again
//     no sooner than two steps later: a ring whose reads all came after the
//     barrier would need 2w+3 columns (the low diagonals live 2w-1 columns).
//     Instead each thread reads band slots j = 0, 1 of both its DP steps
//     before the barrier, after its stores: they were written at least one
//     step before (w >= 2), and a slot read before the barrier of step m is
//     safe from every store after it, which needs 2w+1-j columns. The slots
//     j >= 2, read after it, need 2w + 3 - u + min(u-2, 2) over u >= 2:
//     2w+1. So 2w+1 columns hold; RC takes 2w+2, the loop's even span
//     (tests/test_torch_k1_schedule.py runs every thread's stores of step
//     m+1, and the copies of step m+1, before any read of step m; 2w+1
//     columns pass it, 2w fail).
//   - shared memory (RING_BYTES): the dot ring, E's 2 tiles (8 KB at C = 16)
//     and the T' ring: 27,840 B at w = 5, C = 16. They grow with w and C:
//     K1 takes w <= 20 at C <= 8, w <= 19 at C = 16 (216,640 B), 18 at C =
//     40 (fused_dtw.k1_smem_bytes; the bundle routes wider bands to K4).
//   - the gate counters: given a pointer `counts` to four int64 counters
//     and two per wakeword slot after them (the port's tracing on; null
//     otherwise), thread (0, 0) of each block of the gated launch adds the
//     block's open lanes, its lanes (32 streams or fewer x 3 shifts), 1 if
//     the block works (a lane open and n >= 2) and 1, by four atomics; the
//     open lanes are the barrier's count (__syncthreads_count, which
//     replaced __syncthreads_or). For wakeword d = p / K below `wslots` it
//     adds the open lanes and the 1 if it works again, at slots 4 + 2d and
//     5 + 2d. With the pointer null no atomic runs and nothing else changes.
//   - C and w are compile-time: -DRP_C, -DRP_W. ptxas 12.8 at C = 16, w = 5:
//     128 registers, no spills, 5 blocks (15 warps) per SM. What bounds it
//     (an H100, PERF.md): instruction issue (~555 a warp per step, ~475
//     of them the function's arithmetic and loads) and shared memory, where
//     a warp-uniform LDS.128 of a T' row costs two wavefronts: the step's
//     20 dot-row loads are 4 % of its instructions and 20 % of its time.
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
constexpr int U = W2 + 2;         // template rows per column = diagonals per column
constexpr int SHIFTS = 3;
constexpr int NR = (U + SHIFTS - 1) / SHIFTS;  // dots per column of a shift thread
constexpr int LANES = 32;         // streams per block
constexpr int UNR = W + 1;        // steps per unrolled group
constexpr int RC = 2 * UNR;       // columns of the dot ring and of the rwn register ring
constexpr int RT = W2 + 5;        // rows of the T' ring
constexpr int TROWS = RT + NR;    // with its first NR rows mirrored after it
constexpr int CE = (C + SHIFTS - 1) / SHIFTS;  // coefficient rows a warp copies per column
constexpr int HALF = SHIFTS * LANES / 2;  // threads that copy one column of a step
constexpr int CH = 8 * C;         // 16-byte pieces of a column's tile
constexpr int CHT = (CH + HALF - 1) / HALF;  // pieces a thread copies per step
static_assert(HALF % 8 == 0, "a thread's pieces share their streams");
constexpr int DOT_FLOATS = RC * U * LANES;
constexpr int TILE_FLOATS = 2 * C * LANES;  // E's two columns of a step
constexpr int RING_BYTES = (int)sizeof(float) * (DOT_FLOATS + 2 * TILE_FLOATS + TROWS * C);
static_assert(RING_BYTES <= SMEM_OPTIN, "the rings pass sm_90's shared-memory opt-in");
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(2 * C <= SHIFTS * LANES, "one copy a thread stages a step's two T' rows");

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
  int ph = rot + 1 + k;  // < 2F: rot < F and k < F - 1 where it is used
  if (ph >= a.F) ph -= a.F;
  const unsigned row = nj >= 0 ? nj : ph;
  return (nj >= 0 ? a.newr : a.win) + ((size_t)row * (unsigned)(C * a.B) + (unsigned)b);
}

__device__ __forceinline__ int wrap(int i, int len) { return i >= len ? i - len : i; }

// One 4-byte asynchronous copy from device memory to the shared-memory
// address `dst`.
__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// One 16-byte asynchronous copy, both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Waits for this thread's copies; the barrier after it shows them to all.
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies columns k and k+1 of E (clamped to klast) for this thread's lane
// into the tile at shared address `tile` ([2][C][LANES]), 4 bytes a lane:
// warp s copies the coefficient rows s, s+3, ... (a lane past B copies
// stream B-1). Inline: out of line, its call cost the aligned path 6 %.
__device__ __forceinline__ void stage_narrow(const Args& a, int rot, int k, int klast, int bl,
                                             int s, int lane, unsigned tile) {
#pragma unroll
  for (int col = 0; col < 2; ++col) {
    const float* src = ext_column(a, rot, min(k + col, klast), bl) + (size_t)s * a.B;
    const unsigned dst = tile + (unsigned)(((col * C + s) * LANES + lane) * 4);
#pragma unroll
    for (int i = 0; i < CE; ++i)
      if (SHIFTS * i + SHIFTS - 1 < C || s + SHIFTS * i < C)
        copy4(dst + i * SHIFTS * LANES * 4, src + (size_t)(SHIFTS * i) * a.B);
  }
}

// This thread's share of copying E's columns of a step into its tile
// [2][C][LANES]. Where every coefficient row of the block's streams starts
// 16-byte aligned (B % 4 == 0, aligned window and new rows), `wide`: thread
// t copies column t / HALF's 16-byte pieces j = t % HALF + HALF i, i < CHT
// (j < CH), piece j being coefficient j / 8 of streams 4 (j % 8) ... + 3 (a
// piece past B copies the block's last 4 streams again, for lanes that
// nothing reads); else `stage_narrow`.
struct Stager {
  bool wide;
  bool last;       // wide: the thread's piece CHT - 1 exists
  int col;         // wide: the column this thread copies
  unsigned off;    // wide: element offset of its piece 0 from the column's stream 0
  unsigned dst;    // wide: byte offset of its piece 0 in the tile
  __device__ Stager(const Args& a, int tid, int b0) {
    wide = (a.B & 3) == 0 && ((size_t)a.win & 15) == 0 && ((size_t)a.newr & 15) == 0;
    col = tid / HALF;
    const int j = tid - col * HALF;
    last = j + HALF * (CHT - 1) < CH;
    off = (unsigned)((j / 8) * a.B + min(b0 + 4 * (j % 8), a.B - 4));
    dst = (unsigned)((col * C * LANES + 4 * j) * 4);
  }
  // Copies columns k and k+1 of E (clamped to klast) into the tile at
  // shared address `tile`; bl is this thread's stream, s its shift.
  __device__ __forceinline__ void operator()(const Args& a, int rot, int k, int klast, int bl,
                                             int s, int lane, unsigned tile) const {
    if (!wide) {
      stage_narrow(a, rot, k, klast, bl, s, lane, tile);
      return;
    }
    const float* src = ext_column(a, rot, min(k + col, klast), 0) + off;
#pragma unroll
    for (int i = 0; i < CHT; ++i)  // piece j + HALF i: coefficient + HALF/8 i, same streams
      if (CH % HALF == 0 || i + 1 < CHT || last)
        copy16(tile + dst + 4 * HALF * 4 * i, src + (size_t)(HALF / 8 * i) * a.B);
  }
};

// A warp-uniform T' row of shared memory into registers.
__device__ __forceinline__ void load_row(const float* t, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(t)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = t[c];
  }
}

// v[0]*x[0] + ... as one fp32 FMA chain.
__device__ __forceinline__ float chain(const float (&v)[C], const float (&x)[C]) {
  float acc = v[0] * x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = fmaf(v[c], x[c], acc);
  return acc;
}

// 1/|x - m|, or 0 where the squared norm is 0 or the column is not mine.
__device__ __forceinline__ float rwn(const float (&x)[C], const float (&m)[C], bool mine) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = x[c] - m[c];
    acc = fmaf(d, d, acc);
  }
  return mine && acc != 0.f ? rsqrtf(acc) : 0.f;
}

// The dot ring column of E's column kq - 2w + 1 + j (mod RC), that of
// band slot j of a DP step at column kq.
__host__ __device__ constexpr int slot_column(int kq, int j) {
  return ((kq - W2 + 1 + j) % RC + RC) % RC;
}

// Shift s's DP step of row r at column kq (mod RC) of the step loop: band
// slot j reads diagonal s + j of the dot ring's column slot_column(kq, j)
// at dr (the lane's and the shift's offsets included; slots 0 and 1 were
// read before the barrier, h0 and h1) and rwn of the same column. MASKED:
// slots outside 1 <= r - w + j <= min(n, r + w - 1) cost +inf; an interior
// row (w < r <= n - w + 1) has none.
template <bool MASKED>
__device__ __forceinline__ void dp_step(const float* dr, float h0, float h1, float dm,
                                        const float (&rw)[RC], int kq, int r, int n,
                                        float (&prev)[W2]) {
  const int hi = min(n, r + W - 1);
  float cost[W2], cur[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) {
    const int cdp = r - W + j;
    const float dot = j == 0 ? h0 : j == 1 ? h1 : dr[(slot_column(kq, j) * U + j) * LANES];
    const float c = 1.f - (dot - dm) * rw[slot_column(kq, j)];
    cost[j] = !MASKED || (cdp >= 1 && cdp <= hi) ? c : INFINITY;
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

// One launch: the 3 shifts of pairs pair0 ... pair0 + gridDim.y - 1.
__global__ void __launch_bounds__(LANES * SHIFTS)
    score_pairs(Args a, int pair0, bool gated) {
  // the dot ring [RC][U][LANES], E's tiles [2][2][C][LANES], the T' ring
  // [TROWS][C]
  extern __shared__ __align__(16) float smem[];
  float* const dots = smem;
  float* const tiles = smem + DOT_FLOATS;
  float* const tring = tiles + 2 * TILE_FLOATS;
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
  const int tid = s * LANES + lane;
  const int ti = tid / C, tc = tid - ti * C;  // the T' row and element this thread stages

  // T' row t of pair p is at tp + t * C for 0 <= t <= n - 2 (the rows read)
  const float* tp = a.tpl + ((size_t)p * (a.Lm + W2) + W) * C;
  int rot = *a.rot0 + 1;
  if (rot >= a.F) rot -= a.F;
  const int klast = n + 1;  // the last column of E that shift 2 reads
  const int kend = n + W;   // shift 2's row n-1 is whole after column n + W - 1
  const unsigned tiles_s = (unsigned)__cvta_generic_to_shared(tiles);
  const unsigned tring_s = (unsigned)__cvta_generic_to_shared(tring);
  // step 0's operands: T' rows -w-1 ... w+1 in ring rows 0 ... 2w+2 (the row
  // t of step k's window lies in ring row t + w + 1 - k + tk), the first NR
  // again after the RT, and E's columns 0 and 1 in tile 0
  for (int e = tid; e < (W2 + 3) * C; e += SHIFTS * LANES) {
    const int row = e / C;
    const float* src = tp + min(max(row - W - 1, 0), n - 2) * C + (e - row * C);
    copy4(tring_s + e * 4, src);
    if (row < NR) copy4(tring_s + (RT * C + e) * 4, src);
  }
  const Stager stage(a, tid, blockIdx.x * LANES);
  stage(a, rot, 0, klast, bl, s, lane, tiles_s);
  float m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = a.means[((size_t)(s * a.P + p) * C + c) * a.B + bl];
  copies_landed();
  __syncthreads();

  float rw[RC];  // rw[k % RC] = rwn_s(k) of the last RC columns
  float prev[W2];
#pragma unroll
  for (int j = 0; j < RC; ++j) rw[j] = 0.f;
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  // the lane's dots in the ring: this shift's stores (diagonal U - 1 + col -
  // s*NR - i of column k + col) and its reads (diagonal s + j)
  float* const dw = dots + lane + (U - 1 - s * NR) * LANES;
  const float* const dr = dots + lane + s * LANES;
  unsigned toff = 0;  // byte offset of step k's tile; the other is step k+2's
  int tk = 0;  // k mod RT: the T' ring row of T' row k - w - 1
  for (int k0 = 0; k0 < kend; k0 += RC) {
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      const int k = k0 + 2 * q;  // k0 % RC == 0: column k + c lies in ring column 2q + c
      if (k >= kend) break;
      const unsigned tnext = toff ^ (unsigned)(TILE_FLOATS * 4);
      if (k + 2 < kend) {  // step k+2's operands, into the tile and rows read a step ago
        stage(a, rot, k + 2, klast, bl, s, lane, tiles_s + tnext);
        if (tid < 2 * C) {  // T' row k + w + 2 + ti
          const int j = wrap(tk + RT - 2 + ti, RT);
          const float* src = tp + min(k + W + 2 + ti, n - 2) * C + tc;
          copy4(tring_s + (j * C + tc) * 4, src);
          if (j < NR) copy4(tring_s + ((RT + j) * C + tc) * 4, src);
        }
      }
      const float* const tile = tiles + lane + toff / 4;
      float x0[C], x1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x0[c] = tile[c * LANES];
        x1[c] = tile[(C + c) * LANES];
      }
      // this shift's DP rows t = k + col - w + 1 - s, complete after column
      // k + col; their dotm (the T' ring holds rows clamped into [0, n-2])
      const float* const tdm = tring + wrap(tk + 2 - s, RT) * C;
      float v[C];
      load_row(tdm, v);
      const float dm0 = chain(v, m);
      load_row(tdm + C, v);
      const float dm1 = chain(v, m);
      // column k + col is this shift's column k + col - s
      const float rv0 = rwn(x0, m, k >= s && k - s < n);
      const float rv1 = rwn(x1, m, k + 1 >= s && k + 1 - s < n);
      // dots of rows k - w - 1 + s*NR + i: dv[2i] with column k (i < NR),
      // dv[2i - 1] with column k + 1 (i > 0)
      const float* const trow = tring + wrap(tk + s * NR, RT) * C;
      float dv[2 * NR];
#pragma unroll
      for (int i = 0; i <= NR; ++i) {
        load_row(trow + i * C, v);
        if (i < NR) dv[2 * i] = chain(v, x0);
        if (i > 0) dv[2 * i - 1] = chain(v, x1);
      }
      // unguarded: a row outside [0, n-2] or a column past klast lands where
      // no valid cell reads, and after the last read of what it replaces
#pragma unroll
      for (int e = 0; e < 2 * NR; ++e) {
        const int i = (e + 1) / 2, col = e & 1;
        if (SHIFTS * 2 * NR == 2 * U || s * 2 * NR + e < 2 * U)
          dw[((2 * q + col) * U + col - i) * LANES] = dv[e];
      }
      // band slots 0 and 1 of both DP steps
      const float h00 = dr[(slot_column(2 * q, 0) * U + 0) * LANES];
      const float h01 = dr[(slot_column(2 * q, 1) * U + 1) * LANES];
      const float h10 = dr[(slot_column(2 * q + 1, 0) * U + 0) * LANES];
      const float h11 = dr[(slot_column(2 * q + 1, 1) * U + 1) * LANES];
      copies_landed();
      __syncthreads();
      rw[2 * q] = rv0;
      rw[2 * q + 1] = rv1;
      const int r0 = k - W + 2 - s;  // DP row t + 1 of column k
      if (dp_warp && r0 >= 1 && r0 <= n - 1) {
        if (r0 > W && r0 <= n - W + 1) dp_step<false>(dr, h00, h01, dm0, rw, 2 * q, r0, n, prev);
        else dp_step<true>(dr, h00, h01, dm0, rw, 2 * q, r0, n, prev);
      }
      const int r1 = r0 + 1;
      if (dp_warp && r1 >= 1 && r1 <= n - 1) {
        if (r1 > W && r1 <= n - W + 1) dp_step<false>(dr, h10, h11, dm1, rw, 2 * q + 1, r1, n, prev);
        else dp_step<true>(dr, h10, h11, dm1, rw, 2 * q + 1, r1, n, prev);
      }
      toff = tnext;
      tk = wrap(tk + 2, RT);
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
