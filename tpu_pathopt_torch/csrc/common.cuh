// Shared helpers of the port's CUDA kernels.
//
// Layout convention of K1-K3: every per-scenario array is stored with the
// scenario batch as the fastest-moving axis, e.g. a (N, nb, nb) block array
// of B scenarios is (N, nb, nb, B). K1 gives each scenario a group of 16
// lanes (nb 9), 8 (nb 6) or 4 (nb 3, 4), one per block row, and packs 2, 4
// or 8 scenarios into one warp, so a load reads neighbouring floats of those
// scenarios; K2 and K3 give each scenario a thread block
// (btri_sweep.cuh). K4's arrays are batch-leading: one thread block per
// scenario, with K laterals x P slices of the kp scan as its threads.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pathopt {

// Above this a thread block cannot be launched on the H100 (227 KB).
constexpr int kMaxSmemBytes = 232448;

// Asynchronous 4-byte copy from device memory into shared memory
// (cp.async, sm_80 and later): it does not wait for the load, so copies of
// later steps stay in flight while the current one computes. A thread
// sees its own copies after cp_async_wait; other threads after a barrier.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are
// still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
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
