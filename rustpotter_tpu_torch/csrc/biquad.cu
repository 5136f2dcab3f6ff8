// The band-pass biquad over a batch of streams, for Hopper (sm_90a).
//
// Replaces the JAX package's band-pass scan, which is a lax.scan and not a
// Pallas kernel: rustpotter_tpu/runtime/stream_step.py prepare_chunk (the
// bp_step scan) and rustpotter_tpu/audio/filters.py band_pass_step. It
// computes the function of rustpotter_tpu_torch.ops.biquad.biquad_plain BIT
// FOR BIT: an order-2 IIR in direct form I,
//   y = a0*x + a1*x1 + a2*x2 - b1*y1 - b2*y2,
// evaluated left to right with each product and each sum rounded to fp32.
// The build's flags leave nvcc's --fmad at its default (true), so the
// arithmetic goes through __fmul_rn, __fadd_rn and __fsub_rn, which are never
// contracted into an FMA; a contracted product would round once where the
// plain version rounds twice.
//
// Layout: state (B, 4) fp32 taps [x1, x2, y1, y2] per stream, x (B, n) fp32
// samples; out (B, n) and state_out (B, 4), written once each.
//
// Bound at the serving chunk's shapes (B = 8192 streams, n = 480): 9 FLOP
// per sample (5 products, 4 sums), 35 MFLOP, against 2 x B x n x 4 B = 31.5 MB
// read and written: 0.0094 ms at 3.35 TB/s. So it is bound by bytes, and
// within a stream the recurrence is sequential: y depends on y1 and y2.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): 0.0297
// ms, 3.1x the bound.
//
// Design: the simplest kernel that streams the samples once. One thread per
// stream keeps its four taps in registers and runs the n sequential steps;
// a warp takes 32 streams. Where n is a multiple of 4 and both sample
// pointers are 16-byte aligned (the serving chunk: n = 480 on fresh
// tensors), each thread reads and writes its row as float4, so a warp's
// access is 32 rows x 16 bytes per instruction: uncoalesced across the warp,
// but each row's 128-byte line serves the thread's next loads from L1. The
// loop is unrolled so that loads run ahead of the recurrence. Blocks of 64
// threads spread B = 8192 over 128 of the 132 SMs. Staging a tile of
// streams through shared memory for coalesced loads is left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // streams per block

struct Coeffs {
  float a0, a1, a2, b1, b2;
};

// One step of the recurrence: returns y and shifts the taps.
__device__ __forceinline__ float step(const Coeffs& c, float x, float& x1, float& x2,
                                      float& y1, float& y2) {
  float y = __fadd_rn(__fmul_rn(c.a0, x), __fmul_rn(c.a1, x1));
  y = __fadd_rn(y, __fmul_rn(c.a2, x2));
  y = __fsub_rn(y, __fmul_rn(c.b1, y1));
  y = __fsub_rn(y, __fmul_rn(c.b2, y2));
  x2 = x1;
  x1 = x;
  y2 = y1;
  y1 = y;
  return y;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
    biquad_kernel(const float* __restrict__ state, const float* __restrict__ x,
                  float* __restrict__ state_out, float* __restrict__ out, const Coeffs c,
                  int B, int n) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  float x1 = state[4 * b], x2 = state[4 * b + 1];
  float y1 = state[4 * b + 2], y2 = state[4 * b + 3];
  const size_t row = static_cast<size_t>(b) * n;
  if (VEC4) {
    const float4* xin = reinterpret_cast<const float4*>(x + row);
    float4* yout = reinterpret_cast<float4*>(out + row);
    const int n4 = n / 4;
#pragma unroll 4
    for (int i = 0; i < n4; ++i) {
      const float4 v = __ldg(xin + i);
      float4 o;
      o.x = step(c, v.x, x1, x2, y1, y2);
      o.y = step(c, v.y, x1, x2, y1, y2);
      o.z = step(c, v.z, x1, x2, y1, y2);
      o.w = step(c, v.w, x1, x2, y1, y2);
      yout[i] = o;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < n; ++i) out[row + i] = step(c, __ldg(x + row + i), x1, x2, y1, y2);
  }
  state_out[4 * b] = x1;
  state_out[4 * b + 1] = x2;
  state_out[4 * b + 2] = y1;
  state_out[4 * b + 3] = y2;
}

}  // namespace

// Launch the biquad on `stream`. Returns cudaGetLastError() after the launch:
// a refused launch never runs, so the caller must check this value.
extern "C" int rp_biquad(const void* state, const void* x, void* state_out, void* out,
                         float a0, float a1, float a2, float b1, float b2, void* stream,
                         int B, int n) {
  if (B == 0) return 0;
  const Coeffs c{a0, a1, a2, b1, b2};
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((B + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(state);
  const float* xs = static_cast<const float*>(x);
  float* so = static_cast<float*>(state_out);
  float* ys = static_cast<float*>(out);
  if (vec4) {
    biquad_kernel<true><<<grid, THREADS, 0, s>>>(st, xs, so, ys, c, B, n);
  } else {
    biquad_kernel<false><<<grid, THREADS, 0, s>>>(st, xs, so, ys, c, B, n);
  }
  return (int)cudaGetLastError();
}
