// V1-V6: microbenchmarks of the primitives the DTW kernels are built from,
// for Hopper (sm_90a).
//
// Replace the six TPU probe kernels of tools/vpu_probe.py (k_fma, k_fma_dep,
// k_dynload, k_dynload_cheap, k_sload, k_smemload). Each computes its TPU
// kernel's function lane by lane: a thread computes lane `lane` of the TPU
// kernel's (1, 8, 128) output for the same x (V5: 32 lanes of it), and writes
// it to out[g] of its tile g. A grid of G tiles (the caller sizes it to fill
// the card) writes (G, 8, 128); every tile is the same. The plain versions
// are in rustpotter_tpu_torch/tools/fma_probe.py.
//
// Operands (fp32): x (rows = 64, 8 * 128), s (32, 16), out (G, 8 * 128).
// S (the TPU probe's `streams`, 8 or 32) and the row count of x (ROWS = 64,
// a static shape in the TPU kernel too; the entry point refuses any other)
// are compile-time constants; reps and the 0.5 factor are run-time values,
// so that the compiler keeps every step: fmaf(half, wt, acc) with a run-time
// `half` cannot be split or folded, and it equals the TPU's acc + 0.5 * wt
// exactly (0.5 * wt is exact). The reps loop is not unrolled, as the TPU's
// fori_loop, except V3's, V4's and V6's over their index periods; the S
// steps inside it are. Every lane's steps are the plain version's, in its
// order.
//
// What each measures:
//   V1 fma            S independent FMA chains (the fp32 issue rate);
//   V2 fma_dep        one dependent chain of reps * S FMAs (its latency);
//   V3 dynload        one FMA chain fed by x rows at the index
//                     rem(r * S + i, 64); the TPU divides by a static shape,
//                     so the sequence is known at compile time: each lane
//                     holds its 64 values in registers, and the rep loop,
//                     unrolled over the index period, is FFMAs alone (a
//                     run-time remainder and a load per FMA run at 26x its
//                     bound, PERF.md);
//   V4 dynload_cheap  the same with index (r & 31) + i, which repeats every
//                     32 reps and reads rows 0 ... 30 + S: x's rows in
//                     registers and the rep loop unrolled over 64 reps, as
//                     V3 (a per-lane load per FMA ran at an eighth of the
//                     FMA peak, PERF.md);
//   V5 sload          FMAs fed by s at a dynamic row from shared memory (all
//                     lanes one address: a broadcast). One warp takes a whole
//                     tile, 32 lanes per thread, so each broadcast LDS.128
//                     of s feeds 32 FMA chains, as the TPU's one scalar load
//                     feeds a whole (8, 128) tile's FMA (one lane per thread
//                     ran at 38 % of the FMA peak, PERF.md);
//   V6 smemload       V5's function with s in the TPU's scalar memory, whose
//                     Hopper form is the constant bank: s is copied into a
//                     __constant__ array before each launch, and the rep
//                     loop, unrolled over the 32 reps of the period of
//                     r & 31, reads each s value at an immediate offset,
//                     through uniform registers (a warp-uniform global load
//                     per FMA ran at 4.3x its bound, PERF.md).
// Bound: operations (reps * S FMAs per lane); the bytes are x, s and out.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8 * 128;  // lanes of a TPU (8, 128) tile
constexpr int BLOCK = 256;     // threads per block; a tile is 4 blocks (not V5's)
constexpr int ROWS = 64;       // rows of x: tools/vpu_probe.py's static n_in
constexpr int SLOAD_LANES = 32;                  // V5: lanes per thread
constexpr int SLOAD_BLOCK = TILE / SLOAD_LANES;  // V5: one warp per tile

struct Args {
  const float* x;
  const float* s;
  float* out;
  int reps;
  float half;
};

__device__ __forceinline__ int lane_of() { return (blockIdx.x % (TILE / BLOCK)) * BLOCK + threadIdx.x; }

__device__ __forceinline__ void store(const Args& a, float v) {
  a.out[(size_t)(blockIdx.x / (TILE / BLOCK)) * TILE + lane_of()] = v;
}

template <int S>
__global__ void __launch_bounds__(BLOCK) probe_fma(Args a) {
  const int l = lane_of();
  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = a.x[i * TILE + l] * (1.0f + i);
  const float wt = a.x[S * TILE + l];
#pragma unroll 1
  for (int r = 0; r < a.reps; ++r) {
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = fmaf(a.half, wt, acc[i]);
  }
  float o = acc[0];
#pragma unroll
  for (int i = 1; i < S; ++i) o += acc[i];
  store(a, o);
}

template <int S>
__global__ void __launch_bounds__(BLOCK) probe_fma_dep(Args a) {
  const int l = lane_of();
  float acc = a.x[l];
  const float wt = a.x[TILE + l];
#pragma unroll 1
  for (int r = 0; r < a.reps; ++r) {
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmaf(a.half, wt, acc);
  }
  store(a, acc);
}

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The rep loop unrolled over PERIOD reps, whose steps depend on the rep and
// the step index alone: step(q, i, acc) is step i of a rep whose index
// repeats every PERIOD reps, at rep q of the period. Unrolled, every q and i
// is a compile-time constant, so the loop holds the PERIOD * S steps and its
// loop instructions alone. The last reps % PERIOD reps run straight-line
// after it (no second loop): rep full + q takes the steps of rep q, full
// being a multiple of the period.
template <int S, int PERIOD, class Step>
__device__ __forceinline__ float unrolled_chain(float acc, int reps, const Step& step) {
  const int full = reps - reps % PERIOD;
#pragma unroll 1
  for (int r = 0; r < full; r += PERIOD) {
#pragma unroll
    for (int q = 0; q < PERIOD; ++q) {
#pragma unroll
      for (int i = 0; i < S; ++i) acc = step(q, i, acc);
    }
  }
#pragma unroll
  for (int q = 0; q < PERIOD - 1; ++q) {
    if (full + q < reps) {
#pragma unroll
      for (int i = 0; i < S; ++i) acc = step(q, i, acc);
    }
  }
  return acc;
}

// V3 and V4: one FMA chain fed by x at a row that depends on the rep r and
// the step i alone, through Index::row(r, i), whose sequence repeats every
// Index::PERIOD reps and reads rows 0 ... Index::NX - 1. So the rep loop is
// unrolled over one period and every row is a compile-time register index:
// each lane loads its NX values of x once, and the loop holds the PERIOD * S
// FFMAs alone, no index arithmetic and no load. __fmaf_rn is never split or
// contracted, so every step stays the fmaf of the plain version's order.
template <int S, class Index>
__device__ __forceinline__ void register_chain(const Args& a) {
  constexpr int NX = Index::NX;
  const int l = lane_of();
  float xr[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) xr[k] = a.x[k * TILE + l];
  const float half = a.half;
  store(a, unrolled_chain<S, Index::PERIOD>(xr[0] * 0.0f, a.reps, [&](int q, int i, float acc) {
          return __fmaf_rn(half, xr[Index::row(q, i)], acc);
        }));
}

// V3's rows: rem(r * S + i, ROWS), period 64 / gcd(64, S) (8 reps at S = 8,
// 2 at S = 32), all ROWS rows.
template <int S>
struct DynloadRows {
  static constexpr int PERIOD = ROWS / gcd(ROWS, S), NX = ROWS;
  __host__ __device__ static constexpr int row(int r, int i) { return (r * S + i) % ROWS; }
};

// V4's rows: (r & 31) + i, rows 0 ... 30 + S (39 at S = 8, 63 at S = 32).
// The index repeats every 32 reps; the loop takes two repeats, 64 reps: at
// S = 8 a loop of 32 reps (256 FFMAs) took 1.57 ms and one of 64 (512) 1.08,
// both FFMAs alone (PERF.md; the cause is not visible on the card).
template <int S>
struct CheapRows {
  static constexpr int PERIOD = 64, NX = 31 + S;
  static_assert(NX <= ROWS, "V4 reads rows 0 ... 30 + S of x");
  __host__ __device__ static constexpr int row(int r, int i) { return (r & 31) + i; }
};

template <int S>
__global__ void __launch_bounds__(BLOCK) probe_dynload(Args a) {
  register_chain<S, DynloadRows<S>>(a);
}

template <int S>
__global__ void __launch_bounds__(BLOCK) probe_dynload_cheap(Args a) {
  register_chain<S, CheapRows<S>>(a);
}

// V5: s[(r & 31) * 16 + i % 16] * wt from shared memory. Thread t of block
// g takes lanes t + SLOAD_BLOCK * j (j < SLOAD_LANES) of tile g: one warp
// holds the tile's 1,024 FMA chains, as a TPU vreg group holds the (8, 128)
// tile, and each lane's chain takes the plain version's steps in its order.
// s stays in shared memory, as the TPU kernel's templates stay in VMEM: that
// is what V5 measures (V6 reads it from the constant bank, V4 from
// registers). A rep reads its row's min(S, 16) values, at a run-time row base
// and immediate offsets, as broadcast LDS.128 (all lanes one address), and
// feeds each to the thread's 32 chains. Each LDS.128 costs the SM about 4-5
// FFMA issue slots, so the loads per FFMA bound the loop: the parent, one
// lane per thread, took 2 LDS.128 per 8 FFMAs and 2.71 ms at reps = 2000, S
// = 8. Here the loop holds 2 LDS.128, 256 FFMAs and 5 loop instructions per
// rep at S = 8 (4 and 1,024 at S = 32, each value used twice), 78 registers
// (88), no spills: 1.10 ms, 94 % of its bound (NVIDIA H100 80GB HBM3, 700.00
// W, PERF.md). The launch bounds ask for the 16 tiles per SM of
// fma_probe.TILES_PER_SM; without them ptxas moved the values into uniform
// registers (R2UR, 12 loop instructions) and took 4 % longer. Loops of 64 KB
// and more (4 reps per pass at S = 32) ran at half the rate: unroll nothing.
template <int S>
__global__ void __launch_bounds__(SLOAD_BLOCK, 16) probe_sload(Args a) {
  __shared__ __align__(16) float s[32 * 16];
  for (int i = threadIdx.x; i < 32 * 16; i += SLOAD_BLOCK) s[i] = a.s[i];
  __syncthreads();
  constexpr int NV = S < 16 ? S : 16;  // values of s a rep reads
  float acc[SLOAD_LANES], wt[SLOAD_LANES];
#pragma unroll
  for (int j = 0; j < SLOAD_LANES; ++j) {
    const int l = threadIdx.x + SLOAD_BLOCK * j;
    acc[j] = a.x[l] * 0.0f;
    wt[j] = a.x[TILE + l];
  }
#pragma unroll 1
  for (int r = 0; r < a.reps; ++r) {
    const float4* row = reinterpret_cast<const float4*>(s + (r & 31) * 16);
    float v[NV];
#pragma unroll
    for (int c = 0; c < NV / 4; ++c) {
      const float4 q = row[c];
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int j = 0; j < SLOAD_LANES; ++j) acc[j] = fmaf(v[i % 16], wt[j], acc[j]);
    }
  }
  float* out = a.out + (size_t)blockIdx.x * TILE + threadIdx.x;
#pragma unroll
  for (int j = 0; j < SLOAD_LANES; ++j) out[SLOAD_BLOCK * j] = acc[j];
}

// V6's s, in the constant bank: rp_fma_probe copies the caller's s here on
// the launch's stream before each V6 launch, as the TPU copies s into SMEM.
__constant__ float s_const[32 * 16];

// V6: V5's steps with s[(r & 31) * 16 + i % 16] read from the constant bank
// at an immediate offset. The index repeats every 32 reps, and the loop takes
// one repeat: ptxas then feeds the FFMAs from uniform registers (ULDC). A
// loop of two repeats (V4's 64 reps) took 1.9x as long: each s value used
// twice, ptxas made the FFMAs read the bank directly or loaded s into
// registers (LDC), and at S = 32 spilled (PERF.md).
template <int S>
__global__ void __launch_bounds__(BLOCK) probe_smemload(Args a) {
  const int l = lane_of();
  const float wt = a.x[TILE + l];
  store(a, unrolled_chain<S, 32>(a.x[l] * 0.0f, a.reps, [&](int q, int i, float acc) {
          return fmaf(s_const[(q & 31) * 16 + i % 16], wt, acc);
        }));
}

template <int S>
int launch(int kernel, const Args& a, int tiles, cudaStream_t stream) {
  const dim3 grid((unsigned)(tiles * (TILE / BLOCK))), block(BLOCK);
  switch (kernel) {
    case 0: probe_fma<S><<<grid, block, 0, stream>>>(a); break;
    case 1: probe_fma_dep<S><<<grid, block, 0, stream>>>(a); break;
    case 2: probe_dynload<S><<<grid, block, 0, stream>>>(a); break;
    case 3: probe_dynload_cheap<S><<<grid, block, 0, stream>>>(a); break;
    case 4: probe_sload<S><<<(unsigned)tiles, SLOAD_BLOCK, 0, stream>>>(a); break;  // a warp a tile
    case 5: probe_smemload<S><<<grid, block, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch probe `kernel` (0 fma, 1 fma_dep, 2 dynload, 3 dynload_cheap,
// 4 sload, 5 smemload) with S in {8, 32} chains or steps per rep, on
// `stream`. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unknown kernel or S): a refused launch never runs, so the caller
// must check this value.
extern "C" int rp_fma_probe(int kernel, int S, const void* x, const void* s, void* out,
                            void* stream, int tiles, int reps, int rows, float half) {
  if (rows != ROWS) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(s),
               static_cast<float*>(out), reps, half};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 5) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(s_const, s, sizeof(s_const), 0,
                                                    cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (S == 8) return launch<8>(kernel, a, tiles, st);
  if (S == 32) return launch<32>(kernel, a, tiles, st);
  return (int)cudaErrorInvalidValue;
}
