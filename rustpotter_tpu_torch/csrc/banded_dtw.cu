// K3: the banded-DTW dynamic program over precomputed band costs, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rustpotter_tpu/ops/pallas_dtw.py::_dtw_kernel
// (driven by banded_dtw_pallas). It computes the function of
// rustpotter_tpu_torch.ops.dtw.banded_dtw_batch BIT FOR BIT: the DP is adds
// and mins only, evaluated in the same order, and a min propagates NaN as
// torch.minimum does.
//
// Layout: costs (N, L, 2w) fp32 with costs[e, r-1, j] the cost of DP row r,
// band slot j (DP column r - w + j); lens (N,) i32; out (N,) fp32, the
// similarity = slot w+1 of row n-1 (the padded [m-1][n] cell), +inf for n < 2.
//
// Bound at the per-shift step's shapes (N = B*P = 49,152 at B = 8192, L = 100,
// w = 5): the DP is ~0.2 GOP, a few microseconds at the 67 TFLOP/s fp32 peak,
// but the costs of the rows the DPs need (rows 1 .. n-1 of each entry) are
// 188 MB, 0.056 ms at 3.35 TB/s. So it is bound by bytes: the costs must
// stream from device memory at its full rate while the DP runs.
//
// Design: a stream of the costs into a ring of stages per warp.
//   - A warp owns 32 consecutive entries, one per lane; a block is WARPS such
//     warps with nothing shared between them, so there is no block barrier.
//   - A stage is ROWS DP rows of the warp's 32 entries. The warp copies it
//     into shared memory with cp.async while it runs the DP of an earlier
//     stage: STAGES buffers, STAGES - 1 stages in flight, one commit group per
//     stage (empty groups keep the count uniform), cp.async.wait_group
//     STAGES - 1 before a stage's DP, __syncwarp before a buffer is written
//     again and after its copies land.
//   - Copies are 8 bytes (cp.async.ca ... 8). An entry's rows start at float
//     (e*L + r0 - 1)*2w, always even, so every copy is 8-byte aligned for any
//     L and w; 16-byte copies would need L*w even (L = 99, w = 5 is not).
//     Lane i of a stage's copy loop takes 8-byte unit i of the warp's stage,
//     entry after entry, so neighbouring lanes read neighbouring addresses.
//   - An entry copies only the rows its DP needs (r <= min(n-1, L)); the warp
//     stops after the last row any of its entries needs (__reduce_max_sync
//     over the lanes' min(n-1, L): the old block-wide __syncthreads_or rule,
//     per warp). A warp past the end of the batch copies nothing.
//   - Shared layout per buffer: lane t's entry at t*STRIDE floats, STRIDE/2
//     odd, so a warp's LDS.64 of one row (float2 pairs of band slots) falls in
//     32 distinct banks per half-warp: conflict-free.
//   - The DP frontier (2w floats) stays in registers; rows beyond an entry's
//     n-1 read stale buffer contents, but no cell of them is harvested.
//   - ROWS = clamp(40 / 2w, 1, 8): ~5 KB of payload per warp and stage. At
//     w = 5: ROWS = 4, STRIDE = 42, 64,512 B per block of 4 warps, 3 blocks
//     (12 warps) per SM by shared memory, so the 1,536 warps of the bench
//     shapes are resident in one wave with ~2 x 5 KB in flight each.
//   - The tile is sized from w and lives in dynamic shared memory (opt-in
//     attribute above 48 KB, smem.cuh). W_MAX = 75 is the largest band whose
//     tile (ROWS = 1) fits the 232,448 B opt-in; the wrapper raises ValueError
//     beyond it (ops/banded_dtw.py smem_bytes mirrors SMEM_BYTES).
//
// Compiled at w = 5 (ptxas, cuobjdump -sass): 124 registers, no spills; 60
// LDGSTS.E.64 (the 20 unrolled copies of the loop's stage and of the
// prologue's two), 20 LDS.64 (5 per row), no CALL. The design variants that
// lost to this one, and their times on an H100: PERF.md (the K3 redesign).
#include <cuda_runtime.h>
#include <math.h>

#include "smem.cuh"

#ifndef RP_W
#error "compile with -DRP_W=<band size>"
#endif

namespace {

constexpr int W = RP_W;
constexpr int W2 = 2 * W;
constexpr int LANES = 32;                     // entries per warp
constexpr int WARPS = 4;                      // warps per block
constexpr int STAGES = 3;                     // buffers per warp
constexpr int ROWS = W2 >= 40 ? 1 : (40 / W2 > 8 ? 8 : 40 / W2);  // DP rows per stage
constexpr int UNITS = ROWS * W;               // 8-byte units of one entry's stage
constexpr int STRIDE = 2 * (UNITS | 1);       // floats per entry per buffer
constexpr int STAGE_FLOATS = LANES * STRIDE;
constexpr int WARP_FLOATS = STAGES * STAGE_FLOATS;
constexpr int SMEM_BYTES = 4 * WARPS * WARP_FLOATS;
constexpr int W_MAX = 75;
constexpr unsigned FULL = 0xffffffffu;
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(W <= W_MAX && SMEM_BYTES <= SMEM_OPTIN, "band beyond W_MAX");

// min(a, b) that returns a NaN operand, as torch.minimum does
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// 8 bytes from src to the shared-memory address dst (a 32-bit shared offset)
__device__ __forceinline__ void copy8(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

__global__ void __launch_bounds__(WARPS * LANES)
    banded_dp(const float* __restrict__ costs, const int* __restrict__ lens,
              float* __restrict__ out, int N, int L) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  float* const tile = reinterpret_cast<float*>(smem) + warp * WARP_FLOATS;
  const int e0 = (blockIdx.x * WARPS + warp) * LANES;  // the warp's first entry
  const int e = e0 + lane;
  const int n = e < N ? lens[e] : 1;
  const int last = min(n - 1, L);  // the last DP row this entry needs
  const int wlast = __reduce_max_sync(FULL, last);
  const int nst = wlast >= 1 ? (wlast - 1) / ROWS + 1 : 0;  // stages of the warp
  const int LW2 = L * W2;  // floats between two entries
  const unsigned stile = static_cast<unsigned>(__cvta_generic_to_shared(tile));

  // stage s: rows 1 + s*ROWS ..; each lane copies UNITS of the warp's
  // LANES * UNITS 8-byte units, those of rows its entry needs. Unrolled, the
  // units' offsets stay in registers across stages (124 at w = 5, fewer than
  // shared memory allows), so a copy is a few instructions.
  auto fetch = [&](int s) {
    const int r0 = 1 + s * ROWS;
    const float* const src = costs + ((size_t)e0 * L + (r0 - 1)) * W2;
    const unsigned dst = stile + 4u * (s % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int it = 0; it < UNITS; ++it) {
      const int idx = lane + it * LANES;
      const int ent = idx / UNITS, k = idx - ent * UNITS;
      const int rows = min(__shfl_sync(FULL, last, ent) - r0 + 1, ROWS);
      if (k < rows * W) copy8(dst + 4u * (ent * STRIDE + 2 * k), src + ent * LW2 + 2 * k);
    }
  };

  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  float result = INFINITY;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    commit();
  }
  for (int s = 0; s < nst; ++s) {
    __syncwarp();  // every lane is done with the buffer stage s+STAGES-1 takes
    if (s + STAGES - 1 < nst) fetch(s + STAGES - 1);
    commit();
    wait_stages();  // this lane's copies of stage s have landed
    __syncwarp();   // and every other lane's
    const float* const mine = tile + (s % STAGES) * STAGE_FLOATS + lane * STRIDE;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = 1 + s * ROWS + rr;
      if (r > wlast) break;  // warp-uniform
      const int hi = min(n, r + W - 1);
      const float2* const row = reinterpret_cast<const float2*>(mine + rr * W2);
      float cost[W2], cur[W2];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const float2 v = row[q];
        cost[2 * q] = v.x;
        cost[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < W2; ++j) {
        const int cdp = r - W + j;
        if (!(cdp >= 1 && cdp <= hi)) cost[j] = INFINITY;
        const float ins = j + 1 < W2 ? prev[j + 1] : INFINITY;
        cur[j] = cost[j] + tmin(ins, prev[j]);
      }
      // in-row chain, strictly left to right (the reference's f32 order)
#pragma unroll
      for (int j = 1; j < W2; ++j) cur[j] = tmin(cur[j], cost[j] + cur[j - 1]);
#pragma unroll
      for (int j = 0; j < W2; ++j) {
        const int cdp = r - W + j;
        prev[j] = cdp >= 1 && cdp <= hi ? cur[j] : INFINITY;
      }
      if (r == n - 1) result = prev[W + 1];
    }
  }
  if (e < N) out[e] = result;
}

}  // namespace

// Launch K3 on `stream`. Returns cudaGetLastError() after the launch: a
// refused launch never runs, so the caller must check this value.
extern "C" int rp_banded_dtw(const void* costs, const void* lens, void* out,
                             void* stream, int N, int L) {
  if (N == 0) return 0;
  static SmemOptIn opt_in;
  const cudaError_t attr = opt_in(banded_dp, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int PER_BLOCK = WARPS * LANES;
  banded_dp<<<(N + PER_BLOCK - 1) / PER_BLOCK, PER_BLOCK, SMEM_BYTES,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const int*>(lens),
      static_cast<float*>(out), N, L);
  return (int)cudaGetLastError();
}
