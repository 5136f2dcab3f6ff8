// Dynamic shared memory past the 48 KB a block gets by default, on Hopper
// (sm_90a). Included by the kernels whose shared memory grows with the band
// (K1 fused_dtw_v4.cu, K2 fused_dtw_v3.cu, K3 banded_dtw.cu, K4 fused_dtw_v2.cu,
// K5 fused_dtw_v1.cu) and by the front-end kernel (biquad.cu), whose grows
// with the chunk's samples.
#pragma once
#include <atomic>

#include <cuda_runtime.h>

// The most dynamic shared memory one block may opt into on sm_90: 227 KB.
// rustpotter_tpu_torch/_build.py reads SMEM_OPTIN from this line.
constexpr int SMEM_OPTIN = 232448;

// The most cards a process launches on: device indices 0 to MAX_CARDS - 1.
constexpr int MAX_CARDS = 64;

// Lets one kernel launch with `bytes` of dynamic shared memory on the current
// card: nothing to do up to the 48 KB default, else cudaFuncSetAttribute, once
// per card. The attribute holds only for the card that is current when it is
// set, so a library that launched on card 0 first must set it again before
// its first launch on card 1. Returns the attribute's error on this card
// (cached), or cudaGetDevice's.
//
// A launcher keeps one object per kernel, a static of its own:
//   static SmemOptIn opt_in;
//   const cudaError_t attr = opt_in(kernel, BYTES);
// The object must not live in a shared inline or template function: a static
// there is one object in the whole process (a GNU unique symbol), so every
// library built from one source with the same BYTES would share it, and only
// the first to launch would get the attribute.
//
// Thread-safe: a card's flag is an atomic. Two threads that both launch first
// on a card may both set the attribute; setting it twice is harmless.
class SmemOptIn {
 public:
  template <typename Kernel>
  cudaError_t operator()(Kernel* kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int card = 0;
    cudaError_t err = cudaGetDevice(&card);
    if (err != cudaSuccess) return err;
    if (card < 0 || card >= MAX_CARDS) return cudaErrorInvalidDevice;
    // 0: not set yet on this card; else the attribute's error + 1
    const int done = done_[card].load(std::memory_order_acquire);
    if (done != 0) return static_cast<cudaError_t>(done - 1);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done_[card].store(static_cast<int>(err) + 1, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<int> done_[MAX_CARDS] = {};
};
