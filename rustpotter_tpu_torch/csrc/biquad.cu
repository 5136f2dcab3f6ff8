// The audio front-end's filters over a batch of streams, for Hopper (sm_90a):
// the gain normalizer, then the band-pass biquad, in one launch per chunk.
//
// Replaces the JAX package's gain normalizer and band-pass scan, which are
// jnp code and a lax.scan, not Pallas kernels:
// rustpotter_tpu/runtime/stream_step.py prepare_chunk (the gain block and the
// bp_step scan) and rustpotter_tpu/audio/filters.py band_pass_step. It
// computes the function of rustpotter_tpu_torch.ops.biquad.front_plain BIT
// FOR BIT. Per stream b:
//   - the gain: the rolling rms window shifted by the chunk's rms, its count
//     min(count + 1, W), apply = !isnan(ref) && rms != 0; the mean of the
//     last `count` entries summed in index order, oldest first, zeros
//     included, over the count; gain = floor(ref / sqrt(mean) * 10 + 0.5) *
//     GAIN_STEP clamped to [gain_min, gain_max], 1 where not applied; the
//     window and count kept where not applied; x * gain clamped to [-1, 1]
//     where gain != 1;
//   - the biquad, an order-2 IIR in direct form I,
//       y = a0*x + a1*x1 + a2*x2 - b1*y1 - b2*y2,
//     evaluated left to right.
// Every product, quotient, root and sum is rounded to fp32 by an intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): the build leaves
// nvcc's --fmad at its default (true), and a contracted product would round
// once where the plain version rounds twice. The clamps keep a NaN (torch's
// clamp does; fminf and fmaxf would drop it).
//
// Forms, chosen at compile time: <GAIN, BP> = gain and band-pass, gain only,
// band-pass only (the launcher never runs with both off).
//
// Layout: x and out (B, n) fp32; taps and taps_out (B, 4) fp32 [x1, x2, y1,
// y2]; rms, gain_out (B,) fp32; win, win_out (B, W) fp32; count, count_out
// (B,) int32; ref_sqrt a device scalar (read by pointer, so that a chunk
// never reads the card from the host). Each output is written once. The
// window, count and taps outputs may be their inputs (the stream steps update
// their state in place): a thread reads its row's window, count and taps
// before it writes them, and the bulk form reads the tile's window into shared
// memory before any thread writes it back.
//
// Bound at the serving chunk's shapes (B = 8192 streams, n = 480, W = 33,
// both filters): x read and out written, 2 x 15.73 MB; the window read and
// written, 2 x 1.08 MB; the taps read and written, rms, count in and out and
// the gain, 0.4 MB: 34.0 MB, 0.0102 ms at 3.35 TB/s. 10 FLOP per sample (the
// gain's product, 5 products and 4 sums) and ~W + 5 per stream, 40 MFLOP:
// 0.0006 ms at 67 TFLOP/s. So bytes bound it. Within a stream the recurrence
// is sequential (y depends on y1 and y2): its chain is a product and two sums
// per sample, ~12 cycles, so one stream's 480 samples take ~3 us, under the
// byte bound, if the samples are there when the recurrence wants them.
//
// Design (the bulk form). A block of TILE threads takes TILE streams, one
// thread per stream, and stages each stream's row in shared memory:
//   - first the small loads, so that they do not queue behind the samples:
//     the taps and the gain's scalars into registers, and the tile's window
//     (TILE x W floats, contiguous) by coalesced 4-byte cp.async copies into
//     shared rows of odd stride W | 1;
//   - then each thread copies its own row in with 1-D TMA (cp.async.bulk,
//     global to shared), cut into a few time segments (segments(GAIN):
//     3 with the gain on, 4 for the band-pass alone), each completing on an
//     mbarrier of its own, into rows padded to a stride of n + 4 floats (1936
//     B at n = 480, 16 B past a multiple of 128), so that a warp's float4
//     reads of its rows at one offset hit distinct 16-byte bank groups in
//     each quarter warp: no bank conflicts;
//   - the gain's scalar work runs while the samples fly: the window's entries
//     in use summed in index order (loads batched ahead of the sums), the
//     row shifted in place, the gain rounded;
//   - each thread then runs segment k's recurrence as soon as its mbarrier
//     completes, writes y over x in its row, fences the generic writes
//     against the async proxy, and copies the segment out with cp.async.bulk
//     (shared to global), so that segment k's store overlaps segment k+1's
//     recurrence while later segments' loads are still in flight;
//   - last, the tile's shifted window goes back by coalesced stores.
// A thread waits only on its own row's barriers and copies out only what it
// wrote, so no block barrier sits inside the recurrence. TILE and the
// segment counts were chosen from copies of this source built with the
// library's flags and timed in turns by tools/front_probe.py on an H100
// (NVIDIA H100 80GB HBM3, 700 W; device time of launches back to back in a
// CUDA graph; PERF.md's kernel table). With both filters, 16 streams a
// block: 3 segments 0.0158-0.0162 ms, 4 0.0168-0.0169, 2 0.0191-0.0202, 5
// 0.0178-0.0180 (8 streams a block, 3 and 4 segments: 0.0175-0.0185);
// band-pass only, 4 segments 0.0136-0.0137, 3 0.0138-0.0155. The kernel's
// first design (one thread per stream, float4 loads straight from global)
// took 0.0287-0.0295 ms band-pass only, timed the same way. With the gain on,
// the window's sum runs before the first segment's recurrence, so by then
// more of the row has landed and a fourth segment adds barrier waits and
// copies more than it overlaps; without it the recurrence starts on the
// first segment's arrival, which smaller segments bring sooner. The gain's
// window entries are loaded ahead of the sums (a loop that loads one entry
// per add waits out each load).
//
// Where the bulk copies cannot take the rows (n % 4 != 0, a sample pointer
// not 16-byte aligned, or a tile past the shared-memory opt-in) the simple
// form runs: one thread per stream reading and writing its row directly from
// global memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int TILE = 16;  // streams (threads) per block of the bulk form
// time segments per row of the bulk form, by form (measured: see above)
__host__ __device__ constexpr int segments(bool gain) { return gain ? 3 : 4; }
constexpr int PAD = 4;         // floats of padding per staged row
constexpr int SIMPLE_THREADS = 64;
static_assert(TILE >= 2 && TILE <= 1024, "streams per block");
// the staged rows follow the barriers at a 16-byte boundary
static_assert(TILE % 2 == 0, "an even count of 8-byte barriers");

// fl32(0.1): the gain's step, as ops/biquad.py GAIN_STEP.
constexpr float GAIN_STEP = 0x1.99999ap-4f;

struct Coeffs {
  float a0, a1, a2, b1, b2;
};

struct Gain {
  const float* rms;       // (B,)
  const float* ref_sqrt;  // ()
  const float* win;       // (B, W)
  const int* count;       // (B,)
  float* win_out;         // (B, W)
  int* count_out;         // (B,)
  float* gain_out;        // (B,)
  float lo, hi;           // gain_min, gain_max
  int W;
};

// torch.clamp(v, lo, hi): max then min, and a NaN stays NaN.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

constexpr int UNROLL = 8;  // window entries loaded ahead of their use

// One stream's gain. Reads the window row w_in (W floats, oldest first),
// writes the row after this chunk to w_out (which may be w_in) and the count
// to *count.
__device__ __forceinline__ float stream_gain(float ref, float rms, const float* w_in,
                                             float* w_out, int W, int* count, float lo,
                                             float hi) {
  const bool apply = !isnan(ref) && rms != 0.f;
  const int c = min(*count + 1, W);
  // the shifted window [w_in[1] .. w_in[W - 1], rms], its last c entries in
  // use, summed in index order from entry 0, zeros included
  float total = 0.f;
#pragma unroll 8
  for (int j = 0; j + 1 < W; ++j) {
    const float m = j >= W - c ? w_in[j + 1] : 0.f;
    total = j == 0 ? m : __fadd_rn(total, m);
  }
  total = W == 1 ? rms : __fadd_rn(total, rms);  // the newest is always in use
  // the row after this chunk: shifted where the gain applies, else kept;
  // loads of UNROLL entries before their stores (in place, the stores of a
  // group land below the entries that the next group loads)
  if (apply || w_out != w_in) {
    const int s = apply ? 1 : 0;
    for (int j0 = 0; j0 + 1 < W; j0 += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = j0 + u + 1 < W ? w_in[j0 + u + s] : 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 + u + 1 < W) w_out[j0 + u] = v[u];
    }
    w_out[W - 1] = apply ? rms : w_in[W - 1];
  }
  const float mean = __fdiv_rn(total, static_cast<float>(c));
  float g = __fdiv_rn(ref, __fsqrt_rn(mean));
  g = floorf(__fadd_rn(__fmul_rn(g, 10.f), 0.5f));
  g = clamp_keep_nan(__fmul_rn(g, GAIN_STEP), lo, hi);
  if (apply) *count = c;
  return apply ? g : 1.f;
}

struct Taps {
  float x1, x2, y1, y2;
};

// One sample through the gain (scale = gain != 1) and the biquad.
template <bool GAIN, bool BP>
__device__ __forceinline__ float sample(const Coeffs& c, float x, float g, bool scale,
                                        Taps& t) {
  if (GAIN) {
    const float s = clamp_keep_nan(__fmul_rn(x, g), -1.f, 1.f);
    x = scale ? s : x;
  }
  if (!BP) return x;
  float y = __fadd_rn(__fmul_rn(c.a0, x), __fmul_rn(c.a1, t.x1));
  y = __fadd_rn(y, __fmul_rn(c.a2, t.x2));
  y = __fsub_rn(y, __fmul_rn(c.b1, t.y1));
  y = __fsub_rn(y, __fmul_rn(c.b2, t.y2));
  t.x2 = t.x1;
  t.x1 = x;
  t.y2 = t.y1;
  t.y1 = y;
  return y;
}

__device__ __forceinline__ Taps load_taps(const float* taps, int b) {
  return Taps{taps[4 * b], taps[4 * b + 1], taps[4 * b + 2], taps[4 * b + 3]};
}

__device__ __forceinline__ void store_taps(float* taps, int b, const Taps& t) {
  taps[4 * b] = t.x1;
  taps[4 * b + 1] = t.x2;
  taps[4 * b + 2] = t.y1;
  taps[4 * b + 3] = t.y2;
}

// ---------------------------------------------------------------- simple form

template <bool GAIN, bool BP>
__global__ void __launch_bounds__(SIMPLE_THREADS)
    front_simple(const Gain gn, const float* taps, float* taps_out,
                 const float* __restrict__ x, float* __restrict__ out, const Coeffs c, int B,
                 int n) {
  const int b = blockIdx.x * SIMPLE_THREADS + threadIdx.x;
  if (b >= B) return;
  float g = 1.f;
  if (GAIN) {
    const size_t wrow = static_cast<size_t>(b) * gn.W;
    int count = gn.count[b];
    g = stream_gain(__ldg(gn.ref_sqrt), gn.rms[b], gn.win + wrow, gn.win_out + wrow, gn.W,
                    &count, gn.lo, gn.hi);
    gn.count_out[b] = count;
    gn.gain_out[b] = g;
  }
  const bool scale = g != 1.f;
  Taps t{};
  if (BP) t = load_taps(taps, b);
  const size_t row = static_cast<size_t>(b) * n;
#pragma unroll 8
  for (int i = 0; i < n; ++i) out[row + i] = sample<GAIN, BP>(c, __ldg(x + row + i), g, scale, t);
  if (BP) store_taps(taps_out, b, t);
}

// ------------------------------------------------------------------ bulk form

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Copy `bytes` from global `src` to shared `dst`, completing on `bar` (which
// this thread arrives on, expecting the bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` from shared `src` to global `dst` as one bulk group. The
// caller's generic writes to `src` are made visible to the copy first.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared memory of a bulk block: segments(gain) barriers per stream, the
// staged rows, then the gain window's rows (odd stride).
__host__ __device__ constexpr int window_stride(int W) { return W | 1; }

__host__ __device__ inline size_t bulk_smem_bytes(int n, int W, bool gain) {
  return sizeof(uint64_t) * TILE * segments(gain) + sizeof(float) * TILE * (n + PAD) +
         (gain ? sizeof(float) * TILE * window_stride(W) : 0);
}

// Copy 4 bytes from global to shared without a register (cp.async, waited
// for by cp_async_wait_all).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The row of element i of a tile of rows of W floats: i / W by a float
// reciprocal, corrected to the exact quotient (no loop-carried index, so
// the tile loops unroll).
__device__ __forceinline__ int row_of(int i, int W, float inv_w) {
  int r = __float2int_rz(static_cast<float>(i) * inv_w);
  r += (r + 1) * W <= i;
  r -= r * W > i;
  return r;
}

// segs time segments of `seg` samples each (seg % 4 == 0, n = segs * seg).
template <bool GAIN, bool BP>
__global__ void __launch_bounds__(TILE)
    front_bulk(const Gain gn, const float* taps, float* taps_out,
               const float* __restrict__ x, float* __restrict__ out, const Coeffs c, int B,
               int n, int segs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int b = b0 + tid;
  const bool live = b < B;
  const int seg = n / segs;
  const int stride = n + PAD;
  constexpr int SEGS = segments(GAIN);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + tid * SEGS;
  float* rows = reinterpret_cast<float*>(smem + sizeof(uint64_t) * TILE * SEGS);
  float* row = rows + tid * stride;
  const float* src = x + static_cast<size_t>(b) * n;

  // 1. the small loads first, so that they do not queue behind the samples:
  // the taps and the gain's scalars into registers, and the tile's window
  // (rows_here x W floats, contiguous) by coalesced 4-byte async copies into
  // rows of odd stride
  const int W = gn.W, ws = window_stride(W);
  float* wins = rows + TILE * stride;
  const int rows_here = min(TILE, B - b0);
  Taps t{};
  if (BP && live) t = load_taps(taps, b);
  float ref = 0.f, rms = 0.f;
  int count = 0;
  if (GAIN) {
    if (live) {
      ref = __ldg(gn.ref_sqrt);
      rms = gn.rms[b];
      count = gn.count[b];
    }
    const float* win = gn.win + static_cast<size_t>(b0) * W;
    const float inv_w = 1.f / static_cast<float>(W);
#pragma unroll 4
    for (int i = tid; i < rows_here * W; i += TILE) {
      const int r = row_of(i, W, inv_w);
      cp_async4(wins + r * ws + (i - r * W), win + i);
    }
  }

  // 2. the row's segments in flight
  if (live) {
    for (int k = 0; k < segs; ++k) bar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int k = 0; k < segs; ++k)
      bulk_load(row + k * seg, src + k * seg, seg * sizeof(float), bars + k);
  }

  // 3. the gain while they fly
  float g = 1.f;
  if (GAIN) {
    cp_async_wait_all();
    __syncthreads();
    if (live) {
      float* w = wins + tid * ws;
      g = stream_gain(ref, rms, w, w, W, &count, gn.lo, gn.hi);
      gn.count_out[b] = count;
      gn.gain_out[b] = g;
    }
  }

  // 4. each segment's recurrence as it lands, its store behind it
  if (live) {
    const bool scale = g != 1.f;
    float* dst = out + static_cast<size_t>(b) * n;
    for (int k = 0; k < segs; ++k) {
      bar_wait(bars + k, 0);
      float4* p = reinterpret_cast<float4*>(row + k * seg);
#pragma unroll 4
      for (int i = 0; i < seg / 4; ++i) {
        float4 v = p[i];
        v.x = sample<GAIN, BP>(c, v.x, g, scale, t);
        v.y = sample<GAIN, BP>(c, v.y, g, scale, t);
        v.z = sample<GAIN, BP>(c, v.z, g, scale, t);
        v.w = sample<GAIN, BP>(c, v.w, g, scale, t);
        p[i] = v;
      }
      bulk_store(dst + k * seg, row + k * seg, seg * sizeof(float));
    }
    if (BP) store_taps(taps_out, b, t);
  }

  // 5. the tile's window back, coalesced, once every row of it is shifted
  if (GAIN) {
    __syncthreads();
    float* win_out = gn.win_out + static_cast<size_t>(b0) * W;
    const float inv_w = 1.f / static_cast<float>(W);
#pragma unroll 4
    for (int i = tid; i < rows_here * W; i += TILE) {
      const int r = row_of(i, W, inv_w);
      win_out[i] = wins[r * ws + (i - r * W)];
    }
  }
  if (live) bulk_store_drain();
}

// The time segments for n samples: segments(gain) where they cut n into
// multiples of 4 samples, else one segment; 0 where the bulk form cannot take
// the rows.
int bulk_segments(int n, int W, bool gain, const void* x, const void* out) {
  if (n <= 0 || n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      bulk_smem_bytes(n, W, gain) > static_cast<size_t>(SMEM_OPTIN))
    return 0;
  return n % (4 * segments(gain)) == 0 ? segments(gain) : 1;
}

template <bool GAIN, bool BP>
cudaError_t launch(const Gain& gn, const float* taps, float* taps_out, const float* x,
                   float* out, const Coeffs& c, cudaStream_t s, int B, int n,
                   cudaError_t attr) {
  const int segs = bulk_segments(n, gn.W, GAIN, x, out);
  if (segs == 0) {
    const dim3 grid((B + SIMPLE_THREADS - 1) / SIMPLE_THREADS);
    front_simple<GAIN, BP><<<grid, SIMPLE_THREADS, 0, s>>>(gn, taps, taps_out, x, out, c, B, n);
    return cudaGetLastError();
  }
  if (attr != cudaSuccess) return attr;
  const dim3 grid((B + TILE - 1) / TILE);
  front_bulk<GAIN, BP><<<grid, TILE, bulk_smem_bytes(n, gn.W, GAIN), s>>>(
      gn, taps, taps_out, x, out, c, B, n, segs);
  return cudaGetLastError();
}

}  // namespace

// Launch the front-end filters on `stream`: the gain normalizer if `gain`,
// then the band-pass if `bp` (one of them at least; the pointers of a filter
// that is off may be null). Returns cudaGetLastError() after the launch: a
// refused launch never runs, so the caller must check this value.
extern "C" int rp_front(int gain, int bp, const void* rms, const void* ref_sqrt,
                        const void* win, const void* count, void* win_out, void* count_out,
                        void* gain_out, float gain_min, float gain_max, int W,
                        const void* taps, void* taps_out, float a0, float a1, float a2,
                        float b1, float b2, const void* x, void* out, void* stream, int B,
                        int n) {
  if (B == 0) return 0;
  if (!gain && !bp) return static_cast<int>(cudaErrorInvalidValue);
  const Gain gn{static_cast<const float*>(rms),   static_cast<const float*>(ref_sqrt),
                static_cast<const float*>(win),   static_cast<const int*>(count),
                static_cast<float*>(win_out),     static_cast<int*>(count_out),
                static_cast<float*>(gain_out),    gain_min,
                gain_max,                         W};
  const Coeffs c{a0, a1, a2, b1, b2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  float* to = static_cast<float*>(taps_out);
  const float* xs = static_cast<const float*>(x);
  float* ys = static_cast<float*>(out);
  // the opt-in past 48 KB of shared memory, once per form and card
  if (gain && bp) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(front_bulk<true, true>, SMEM_OPTIN);
    return static_cast<int>(launch<true, true>(gn, tp, to, xs, ys, c, s, B, n, attr));
  }
  if (gain) {
    static SmemOptIn opt_in;
    const cudaError_t attr = opt_in(front_bulk<true, false>, SMEM_OPTIN);
    return static_cast<int>(launch<true, false>(gn, tp, to, xs, ys, c, s, B, n, attr));
  }
  static SmemOptIn opt_in;
  const cudaError_t attr = opt_in(front_bulk<false, true>, SMEM_OPTIN);
  return static_cast<int>(launch<false, true>(gn, tp, to, xs, ys, c, s, B, n, attr));
}
