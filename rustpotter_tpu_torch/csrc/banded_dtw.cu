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
// w = 5): the DP needs ~40 adds and mins per row and entry (~0.2 GOP, a few
// microseconds at the 67 TFLOP/s fp32 peak), but its costs are 197 MB, ~0.06
// ms at 3.35 TB/s. So it is bound by bytes: what matters is reading the costs
// once, coalesced.
//
// Design: one thread = one entry e; a block is 128 entries. An entry's rows
// are contiguous, but neighbouring entries are L*2w floats apart, so a thread
// reading its own rows would not coalesce. Instead the block stages ROWS rows
// of all its entries at a time in shared memory (each entry's ROWS*2w floats
// are contiguous, and consecutive threads load consecutive addresses), then
// every thread runs those ROWS DP steps out of shared memory, with its 2w
// frontier in registers. The row stride in shared memory is odd, so the
// threads' reads fall in distinct banks. The block stops after the last row
// any of its entries needs (row n-1). w is compile-time (-DRP_W).
#include <cuda_runtime.h>
#include <math.h>

#ifndef RP_W
#error "compile with -DRP_W=<band size>"
#endif

namespace {

constexpr int W = RP_W;
constexpr int W2 = 2 * W;
constexpr int THREADS = 128;     // entries per block
constexpr int ROWS = 8;          // DP rows staged per step
constexpr int SPAN = ROWS * W2;  // floats of one entry per step
constexpr int STRIDE = SPAN | 1; // odd: conflict-free per-thread rows
static_assert(W >= 2, "the similarity slot w+1 must lie inside the 2w band");
static_assert(THREADS * STRIDE * 4 <= 48 * 1024, "static shared memory");

// min(a, b) that returns a NaN operand, as torch.minimum does
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(THREADS)
    banded_dp(const float* __restrict__ costs, const int* __restrict__ lens,
              float* __restrict__ out, int N, int L) {
  __shared__ float tile[THREADS * STRIDE];
  const int e0 = blockIdx.x * THREADS;
  const int e = e0 + threadIdx.x;
  const int n = e < N ? lens[e] : 1;
  const int here = min(THREADS, N - e0);  // entries of this block

  float prev[W2];
#pragma unroll
  for (int j = 0; j < W2; ++j) prev[j] = j == W ? 0.f : INFINITY;
  float result = INFINITY;

  for (int r0 = 1; r0 <= L; r0 += ROWS) {
    // rows r0 .. r0 + ROWS - 1 are needed iff some entry has n - 1 >= r0
    if (!__syncthreads_or(n - 1 >= r0)) break;
    const int rows = min(ROWS, L - r0 + 1);
    for (int i = threadIdx.x; i < here * SPAN; i += THREADS) {
      const int ent = i / SPAN, k = i - ent * SPAN;
      if (k < rows * W2)
        tile[ent * STRIDE + k] =
            costs[((size_t)(e0 + ent) * L + (r0 - 1)) * W2 + k];
    }
    __syncthreads();
    const float* mine = tile + threadIdx.x * STRIDE;
    for (int rr = 0; rr < rows; ++rr) {
      const int r = r0 + rr;
      const int hi = min(n, r + W - 1);
      float cost[W2], cur[W2];
#pragma unroll
      for (int j = 0; j < W2; ++j) {
        const int cdp = r - W + j;
        const bool valid = cdp >= 1 && cdp <= hi;
        cost[j] = valid ? mine[rr * W2 + j] : INFINITY;
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
  banded_dp<<<(N + THREADS - 1) / THREADS, THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const int*>(lens),
      static_cast<float*>(out), N, L);
  return (int)cudaGetLastError();
}
