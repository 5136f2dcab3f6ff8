// The MFCC front-end's elementwise work around the windowed-DFT product, for
// Hopper (sm_90a): a prologue before the product and an epilogue after it.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA's fusions
// (rustpotter_tpu/ops/frontend.py pre_emphasis and mfcc_from_frames,
// rustpotter_tpu/runtime/stream_step.py make_batched_chunk's extractor
// buffer). In PyTorch the batched chunk ran it in 16 elementwise launches and
// two small sgemms a chunk, the largest on strided (B, 3, 480) views. The windowed DFT between
// the two kernels stays one cuBLAS sgemm (ops/frontend.py mfcc_from_frames).
//
// mfcc_prologue (the batched chunk's alone): per stream b, from the chunk's
// 480 samples x and the extractor buffer, the last three pre-emphasized
// shifts (480 samples),
//   - the pre-emphasis of each 160-sample shift with the carry reset to 0 at
//     each shift (extractor.rs:87-97): x[j] - x[j-1] * 0.97, the product and
//     the difference each rounded to fp32 (__fmul_rn, __fsub_rn: the build
//     leaves --fmad on, and a contracted product would round once where the
//     plain version rounds twice), so the frames and buffer are bit-equal to
//     ops/frontend.py prologue_plain;
//   - the three frames packed (B, 3, 480): frame s is [buffer, shifts][160 s,
//     160 s + 480), so frame 0 is the old buffer (the batched chunk hears a
//     shift late, as the JAX package's);
//   - the new buffer, the chunk's pre-emphasized shifts, written over the old
//     one (each float4 of it by the thread that read the old float4 there,
//     after that read);
//   - with RMS, sqrt(mean(x^2)) from the same read (summed in another order
//     than torch's reduction: within rtol 2e-6 of it).
// Bound: it reads 3,840 B and writes 7,680 B a stream (7,684 with the rms):
// at B = 65536, 755 MB, 0.225 ms at 3.35 TB/s. Nothing else bounds it.
// Design: a thread per float4 u of the chunk and of the buffer (120 a
// stream), for REPS streams, their loads issued before any store; 4 stores a
// stream. Timed at B = 65536 (NVIDIA H100 80GB HBM3, 700 W; CUDA graphs,
// tools/front_probe.py --mfcc): REPS = 2 0.2656 ms (85 % of the bound), 3
// 0.2666, 1 0.2769-0.2776, and one stream a thread with each store right
// behind its loads 0.2989-0.3030.
//
// mfcc_epilogue: per row of the product's spectrum (..., 480) = [re 240 | im
// 240], in fp32,
//   - the power re*re + im*im (__fmul_rn, __fmul_rn, __fadd_rn: as torch's
//     three launches round);
//   - the mel bank's N bands, each summed by FMA over its bins in ascending
//     order from 0 (the zero weights outside a band add nothing), from the
//     constants of ops/frontend.py (the same matrix as the plain version's);
//   - log(mel + f32::MIN_POSITIVE) by logf (libdevice's, as torch.log);
//   - the DCT's rows 1 .. N-1 (coefficient 0 dropped), FMAs in index order;
//     where the N logs are all equal to one value v (digital silence: every
//     band's power is 0, so v = log(f32::MIN_POSITIVE) = -87.34), the exact
//     sum v * (the DCT row's sum, `dsum`) rounded once: there the terms
//     cancel to below 1e-3 from partial sums of up to ~170, so an fp32 sum
//     is off by a few ulps of those (orders differ by up to 5e-5), and K1's
//     CMN of a run of such frames scores whatever residue that leaves
//     (ROADMAP F5); the rounded exact value depends on no order;
// written as (..., N - 1) rows, or with WINDOW, for rows (b, s) of a (B, S)
// leading shape, as (S, N - 1, B): the window's layout, so the batched chunk
// copies nothing after it. The mel and DCT sums run in another order than
// cuBLAS may: held at rtol 1e-5 / atol 1e-5 to the plain version.
// The bands are triangles over consecutive centres c_0 <= ... <= c_{N+1}
// (band i rises over [c_i, c_{i+1}) and falls over [c_{i+1}, c_{i+2})), so a
// bin is in at most two bands: the one rising (weight wr[k]) and the one
// falling (wf[k]). One walk over the bins keeps two sums, the rising band's
// and the falling band's; at each centre (cut[k] of them before bin k) the
// falling band is done and is stashed in shared memory, the rising one falls.
// ops/frontend.py epilogue_tables builds wr, wf and cut from the matrix and
// checks that it has no weight elsewhere.
// Bound: it reads 1,920 B and writes 4 (N - 1) B a row: at B = 65536 and N =
// 17 (196,608 rows), 390 MB, 0.116 ms at 3.35 TB/s; ~1,000 FLOPs a row,
// 0.2 GFLOP, 0.003 ms at 67 TFLOP/s. So bytes bound it.
// Design: one thread per row, so that the bin walk is uniform across a warp.
// A block of ROWS threads takes ROWS consecutive rows and streams them
// through DEPTH slots of shared memory, PIECE bins (re and im) a row at a
// time, by 16-byte asynchronous copies (cp.async, LDGSTS: no register holds a
// load) that consecutive threads issue on consecutive chunks of a row, so
// that pieces p + 1 .. p + DEPTH - 1 are in flight while each thread walks
// piece p of its own row. A slot's rows are padded to STRIDE floats (20 mod
// 32 banks at PIECE = 40), so a quarter warp's float4 reads of 8 rows at one
// offset hit distinct banks. The walk's weights and cuts sit in shared memory
// (a warp reads each at one address), the DCT's rows in the parameters'
// constant bank (read once a row, at the end). The loops over pieces and over
// the bands' logs are rolled: with the whole walk unrolled (~3,000
// instructions a row) the kernel took 0.36 ms at B = 65536, 32 % of its
// bound, and rolled 0.19 ms (NVIDIA H100 80GB HBM3, 700 W; CUDA graphs,
// tools/front_probe.py --mfcc): as though its warps waited on instruction
// fetches. A first design staged each thread's row by 1-D TMA, 8 bulk copies
// of 240 B a row, unrolled: 0.72 ms. Rolled, the same way (PIECE, ROWS,
// DEPTH): 40, 128, 2 0.1664-0.1675 ms (70 % of the bound); 40, 64, 2 0.1674;
// 40, 64, 3 0.1649; 20, 128, 2 0.1890; 20, 128, 3 0.1868; 20, 64, 3 0.1880;
// 60, 128, 2 0.2317.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "smem.cuh"

// Built without RP_N, the prologue alone (rp_mfcc_prologue), and with RP_N,
// the mel bands (MFCC coefficients + 1), once for each count the epilogue
// runs at (rp_mfcc_epilogue: its tables' shape is built in).

namespace {

constexpr int FRAME = 480;  // samples a frame and floats a spectrum row
constexpr int SHIFT = 160;
constexpr float PRE_EMPHASIS = 0.97f;  // MFCCS_EXTRACTOR_PRE_EMPHASIS

// ------------------------------------------------------------------ prologue

constexpr int UNITS = FRAME / 4;            // float4s of a chunk and of the buffer: 120
constexpr int PRO_STREAMS = 4;              // streams a group: a thread per float4 of each
constexpr int PRO_THREADS = PRO_STREAMS * UNITS;  // 480
constexpr int REPS = 2;                     // groups a block: streams a thread
static_assert(REPS * PRO_STREAMS <= PRO_THREADS / 32, "a warp for each stream's rms");

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float pre(float x, float prev) {
  return __fsub_rn(x, __fmul_rn(prev, PRE_EMPHASIS));
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

template <bool RMS>
__global__ void __launch_bounds__(PRO_THREADS)
    mfcc_prologue(const float* __restrict__ x, float* buf, float* __restrict__ frames,
                  float* __restrict__ rms, int B) {
  const int tid = threadIdx.x;
  const int local = tid / UNITS;
  const int u = tid - local * UNITS;
  const int j = 4 * u;
  // every load of the thread's REPS streams first, then their stores
  float4 v[REPS], old[REPS];
  float prev[REPS];
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const int b = (blockIdx.x * REPS + r) * PRO_STREAMS + local;
    if (b < B) {
      const float* xr = x + static_cast<size_t>(b) * FRAME;
      v[r] = ld4(xr + j);
      prev[r] = j % SHIFT == 0 ? 0.f : __ldg(xr + j - 1);
      // not __ldg: this thread writes it below
      old[r] = *reinterpret_cast<const float4*>(buf + static_cast<size_t>(b) * FRAME + j);
    }
  }
  float part[REPS];
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const int b = (blockIdx.x * REPS + r) * PRO_STREAMS + local;
    part[r] = 0.f;
    if (b < B) {
      float* br = buf + static_cast<size_t>(b) * FRAME;
      float* fr = frames + static_cast<size_t>(b) * 3 * FRAME;
      const float4 e = make_float4(pre(v[r].x, prev[r]), pre(v[r].y, v[r].x),
                                   pre(v[r].z, v[r].y), pre(v[r].w, v[r].z));
      st4(br + j, e);      // the new buffer, where this thread read
      st4(fr + j, old[r]);  // frame 0 = the old buffer
      if (j >= SHIFT) st4(fr + FRAME + j - SHIFT, old[r]);  // frame 1 = buffer[160, 480) + ...
      else st4(fr + FRAME + 2 * SHIFT + j, e);              //   ... shift 0
      if (j >= 2 * SHIFT) st4(fr + 2 * FRAME + j - 2 * SHIFT, old[r]);  // frame 2 = buffer[320,
      else st4(fr + 2 * FRAME + SHIFT + j, e);  // 480) + shifts 0, 1
      if (RMS)
        part[r] = __fadd_rn(__fadd_rn(sq(v[r].x), sq(v[r].y)), __fadd_rn(sq(v[r].z), sq(v[r].w)));
    }
  }
  if (RMS) {
    __shared__ float parts[REPS][PRO_THREADS];
#pragma unroll
    for (int r = 0; r < REPS; ++r) parts[r][tid] = part[r];
    __syncthreads();
    const int w = tid / 32, lane = tid % 32;
    // warp w sums stream w % PRO_STREAMS of group w / PRO_STREAMS
    const int r = w / PRO_STREAMS, sl = w - r * PRO_STREAMS;
    const int sb = (blockIdx.x * REPS + r) * PRO_STREAMS + sl;
    if (r < REPS && sb < B) {
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < UNITS; i += 32) s += parts[r][sl * UNITS + i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) rms[sb] = __fsqrt_rn(__fdiv_rn(s, static_cast<float>(FRAME)));
    }
  }
}

}  // namespace

// The prologue on `stream` over B streams: x (B, 480), buf (B, 480) read and
// written in place, frames (B, 3, 480), rms (B,) or null for none. Every
// pointer 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int rp_mfcc_prologue(const void* x, void* buf, void* frames, void* rms, void* stream,
                                int B) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + REPS * PRO_STREAMS - 1) / (REPS * PRO_STREAMS));
  const float* xs = static_cast<const float*>(x);
  float* bs = static_cast<float*>(buf);
  float* fs = static_cast<float*>(frames);
  if (rms)
    mfcc_prologue<true><<<grid, PRO_THREADS, 0, s>>>(xs, bs, fs, static_cast<float*>(rms), B);
  else
    mfcc_prologue<false><<<grid, PRO_THREADS, 0, s>>>(xs, bs, fs, nullptr, B);
  return static_cast<int>(cudaGetLastError());
}

#ifdef RP_N
namespace {

// ------------------------------------------------------------------ epilogue

constexpr int BINS = 240;
constexpr int N = RP_N;
static_assert(N >= 2 && N <= 64, "mel bands: ops/frontend.py N_MAX");

constexpr int PIECE = 40;  // bins of a slot: re then im, 2 x 160 B a row
constexpr int PIECES = BINS / PIECE;
constexpr int DEPTH = 2;  // slots: pieces in flight or walked
constexpr int ROWS = 128;  // rows, and threads, a block
constexpr int STRIDE = 2 * PIECE + 4;  // floats a row of a slot
constexpr int CHUNKS = PIECE / 2;  // 16-byte copies a row of a slot: re, then im
constexpr int MEL_STRIDE = N | 1;  // odd: a uniform index hits distinct banks
static_assert(BINS % PIECE == 0 && PIECE % 4 == 0, "whole float4s a slot");
static_assert(STRIDE % 32 == 4 || STRIDE % 32 == 12 || STRIDE % 32 == 20 || STRIDE % 32 == 28,
              "a quarter warp's float4 reads of 8 rows at one offset on distinct banks");

// The layout is this file's alone: rp_mfcc_tables_layout reports each
// field's offset and size, and ops/frontend.py pack_tables places the
// fields of epilogue_tables by name at them.
struct Walk {
  float wr[BINS];           // bin k's weight in the band rising over it
  float wf[BINS];           // bin k's weight in the band falling over it
  unsigned char cut[BINS];  // centres at bin k: bands that end before it
};
struct Tables {
  Walk walk;
  float dct[N - 1][N];  // rows 1 .. N-1 of the DCT: out[c] = sum_j lm[j] dct[c][j]
  double dsum[N - 1];   // sum_j dct[c][j], correctly rounded: a constant row's DCT
};
static_assert(sizeof(Walk) % 16 == 0, "the slots follow the walk's tables at 16 bytes");

constexpr size_t epi_smem_bytes() {
  return sizeof(Walk) + sizeof(float) * ROWS * (DEPTH * STRIDE + MEL_STRIDE);
}
static_assert(epi_smem_bytes() <= SMEM_OPTIN, "the epilogue's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Piece p of the block's rows into a slot, if p < PIECES: 16-byte
// asynchronous copies (cp.async, past L1), consecutive threads on consecutive
// chunks of a row; one commit group each call, empty past the last piece.
__device__ __forceinline__ void load_piece(float* slot, const float* rows, int rows_here, int p) {
  const int n = p < PIECES ? rows_here * CHUNKS : 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += ROWS) {
    const int r = i / CHUNKS, q = i - r * CHUNKS;
    const int half = q / (CHUNKS / 2), c = q - half * (CHUNKS / 2);
    const float* src = rows + static_cast<size_t>(r) * FRAME + half * BINS + p * PIECE + 4 * c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(slot + r * STRIDE + half * PIECE + 4 * c)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool WINDOW>
__global__ void __launch_bounds__(ROWS)
    mfcc_epilogue(const __grid_constant__ Tables t, const float* __restrict__ spec,
                  float* __restrict__ out, int M, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * ROWS;
  const int m = m0 + tid;
  const int rows_here = min(ROWS, M - m0);
  const bool live = m < M;
  // the walk's tables in shared memory, each read at one address by a warp
  Walk& w = *reinterpret_cast<Walk*>(smem);
  float* slots = reinterpret_cast<float*>(smem + sizeof(Walk));  // [DEPTH][ROWS][STRIDE]
  float* mel = slots + DEPTH * ROWS * STRIDE + tid * MEL_STRIDE;
  const float* rows = spec + static_cast<size_t>(m0) * FRAME;
  for (int i = tid; i < static_cast<int>(sizeof(Walk) / 4); i += ROWS)
    reinterpret_cast<uint32_t*>(smem)[i] = reinterpret_cast<const uint32_t*>(&t.walk)[i];

  // the bin walk: `rise` sums the band rising over the bin, `fall` the band
  // falling over it; j counts the centres passed, so the falling band is j - 2
  float rise = 0.f, fall = 0.f;
  int j = 0;
#pragma unroll
  for (int p = 0; p < DEPTH - 1; ++p) load_piece(slots + p * ROWS * STRIDE, rows, rows_here, p);
#pragma unroll 1
  for (int p = 0; p < PIECES; ++p) {
    float* slot = slots + (p % DEPTH) * ROWS * STRIDE;
    const int next = p + DEPTH - 1;  // into the slot walked at p - 1
    load_piece(slots + (next % DEPTH) * ROWS * STRIDE, rows, rows_here, next);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH - 1) : "memory");
    __syncthreads();  // every thread's copies of piece p have landed
    if (live) {
      const float* row = slot + tid * STRIDE;
#pragma unroll
      for (int q = 0; q < PIECE; q += 4) {
        const int k0 = p * PIECE + q;
        const float4 a = *reinterpret_cast<const float4*>(row + q);
        const float4 c = *reinterpret_cast<const float4*>(row + PIECE + q);
        const float4 r4 = *reinterpret_cast<const float4*>(w.wr + k0);
        const float4 f4 = *reinterpret_cast<const float4*>(w.wf + k0);
        const uint32_t cuts = *reinterpret_cast<const uint32_t*>(w.cut + k0);
        const float pw[4] = {__fadd_rn(sq(a.x), sq(c.x)), __fadd_rn(sq(a.y), sq(c.y)),
                             __fadd_rn(sq(a.z), sq(c.z)), __fadd_rn(sq(a.w), sq(c.w))};
        const float wr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float wf[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          for (uint32_t n = (cuts >> (8 * i)) & 0xffu; n > 0; --n, ++j) {
            if (j >= 2) mel[j - 2] = fall;
            fall = rise;
            rise = 0.f;
          }
          rise = fmaf(pw[i], wr[i], rise);
          fall = fmaf(pw[i], wf[i], fall);
        }
      }
    }
    __syncthreads();  // every thread is done with the slot piece p + DEPTH refills
  }
  if (!live) return;
  for (; j < N + 2; ++j) {  // centres past the last bin
    if (j >= 2) mel[j - 2] = fall;
    fall = rise;
    rise = 0.f;
  }

#pragma unroll 1
  for (int i = 0; i < N; ++i) mel[i] = logf(__fadd_rn(mel[i], FLT_MIN));
  float lm[N];
  bool flat = true;  // a constant row: its DCT is lm[0] * dsum, rounded once
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lm[i] = mel[i];
    flat = flat && lm[i] == lm[0];
  }
  constexpr int C = N - 1;
  const int b = WINDOW ? m / S : m;
  const int s = WINDOW ? m - b * S : 0;
  const size_t B = static_cast<size_t>(M / S);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc = fmaf(lm[i], t.dct[c][i], acc);
    if (flat) acc = __double2float_rn(__dmul_rn(static_cast<double>(lm[0]), t.dsum[c]));
    if (WINDOW)
      out[(static_cast<size_t>(s) * C + c) * B + b] = acc;
    else
      out[static_cast<size_t>(m) * C + c] = acc;
  }
}

}  // namespace

// The layout of Tables: the offset and the size in bytes of wr, wf, cut, dct
// and dsum, in that order, then sizeof(Tables), into out[0 .. 10].
extern "C" void rp_mfcc_tables_layout(int* out) {
  const int fields[5][2] = {
      {static_cast<int>(offsetof(Tables, walk) + offsetof(Walk, wr)), sizeof(Walk::wr)},
      {static_cast<int>(offsetof(Tables, walk) + offsetof(Walk, wf)), sizeof(Walk::wf)},
      {static_cast<int>(offsetof(Tables, walk) + offsetof(Walk, cut)), sizeof(Walk::cut)},
      {static_cast<int>(offsetof(Tables, dct)), sizeof(Tables::dct)},
      {static_cast<int>(offsetof(Tables, dsum)), sizeof(Tables::dsum)}};
  for (int i = 0; i < 5; ++i) {
    out[2 * i] = fields[i][0];
    out[2 * i + 1] = fields[i][1];
  }
  out[10] = static_cast<int>(sizeof(Tables));
}

// The epilogue on `stream` over M rows of spec (M, 480), 16-byte aligned;
// `tables` is host memory holding a Tables. out is (M, N - 1), or with
// `window` (S, N - 1, M / S) for rows (b, s) of a (M / S, S) leading shape.
// Returns cudaGetLastError() after the launch.
extern "C" int rp_mfcc_epilogue(const void* tables, const void* spec, void* out, void* stream,
                                int M, int S, int window) {
  if (M == 0) return 0;
  if (S <= 0 || M % S != 0) return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  memcpy(&t, tables, sizeof(Tables));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + ROWS - 1) / ROWS);
  const float* sp = static_cast<const float*>(spec);
  float* o = static_cast<float*>(out);
  if (window) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(mfcc_epilogue<true>, epi_smem_bytes());
    if (attr != cudaSuccess) return static_cast<int>(attr);
    mfcc_epilogue<true><<<grid, ROWS, epi_smem_bytes(), s>>>(t, sp, o, M, S);
  } else {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(mfcc_epilogue<false>, epi_smem_bytes());
    if (attr != cudaSuccess) return static_cast<int>(attr);
    mfcc_epilogue<false><<<grid, ROWS, epi_smem_bytes(), s>>>(t, sp, o, M, 1);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // RP_N
