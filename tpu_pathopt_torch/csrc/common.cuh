// Shared helpers of the port's CUDA kernels.
//
// Layout convention of K1-K3: every per-scenario array is stored with the
// scenario batch as the fastest-moving axis, e.g. a (N, nb, nb) block array
// of B scenarios is (N, nb, nb, B). In K1 and K4 one thread owns one
// scenario, so the 32 threads of a warp read 32 neighbouring floats on every
// load; K2 and K3 give each scenario a thread block (btri_sweep.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pathopt {

// Threads per block for the one-thread-per-scenario kernels. One warp per
// block spreads a batch of B scenarios over B/32 SMs instead of packing
// them onto B/128.
constexpr int kScenarioThreads = 32;

inline int scenario_blocks(int batch) {
  return (batch + kScenarioThreads - 1) / kScenarioThreads;
}

// max(|a|, m) that propagates NaN like jnp.max / torch.amax do.
__device__ __forceinline__ float absmax(float m, float a) {
  const float x = fabsf(a);
  return (x > m || x != x) ? x : m;
}

// max(a, b) that propagates NaN (jnp.maximum).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Launch status for the host: the error of the launch itself (a refused
// configuration never runs and is not reported by a later synchronize).
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace pathopt
