// Dynamic shared memory past the 48 KB a block gets by default, on Hopper
// (sm_90a). Included by the kernels whose shared memory grows with the band
// (K1 fused_dtw_v4.cu, K2 fused_dtw_v3.cu, K3 banded_dtw.cu, K4 fused_dtw_v2.cu,
// K5 fused_dtw_v1.cu) and by the front-end kernel (biquad.cu), whose grows
// with the chunk's samples.
#pragma once
#include <cuda_runtime.h>

// The most dynamic shared memory one block may opt into on sm_90: 227 KB.
// rustpotter_tpu_torch/_build.py reads SMEM_OPTIN from this line.
constexpr int SMEM_OPTIN = 232448;

// Lets `kernel` launch with `bytes` of dynamic shared memory: nothing to do up
// to the 48 KB default, else cudaFuncSetAttribute. Returns its error.
//
// A launcher calls it once per process, into a static of its own:
//   static const cudaError_t attr = opt_in_smem(kernel, BYTES);
// The static must not live in here: a static of an inline or template function
// is one object in the whole process (a GNU unique symbol), so every library
// built from one source with the same BYTES would share it, and only the first
// to launch would get the attribute.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
