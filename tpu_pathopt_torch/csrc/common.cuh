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
#include <cstdint>

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

// This thread's shared-memory address of p.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A shared-memory barrier (mbarrier) that `count` arrivals and the bytes
// of the copies expected on it complete. Make it visible before use
// (fence_barrier_init, then a barrier of the threads).
__device__ __forceinline__ void barrier_init(uint64_t* bar,
                                             unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on `bar` (release: this thread's earlier shared-memory reads
// and writes are ordered before the phase completes).
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival on `bar` that also expects `bytes` of bulk copies on it.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued is
// complete (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's earlier writes before bulk copies (the async proxy)
// that read them, once a barrier has passed.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// One bulk copy (the Tensor Memory Accelerator) of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from device memory into this CTA's
// shared memory, its bytes counted on `bar` (expected there by
// expect_bytes).
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bulk_copy with its own arrival: completes the current phase of a
// barrier of one arrival.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  expect_bytes(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
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

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), NaN if any of the
// three is NaN as in jnp.minimum / jnp.maximum (fminf and fmaxf would drop
// a NaN bound).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(x), "f"(lo));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(m) : "f"(hi));
  return m;
}

// Launch status for the host: the error of the launch itself (a refused
// configuration never runs and is not reported by a later synchronize).
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Launch `kernel` over `grid` CTAs in clusters of `cluster` (> 1), after
// giving it the most shared memory an SM has (so that the occupancy the
// registers allow is not cut by an L1-sized carveout) and checking that a
// cluster of them fits on the card. The kernel's dynamic shared memory
// size must be set already.
template <class Args>
int launch_clustered(void (*kernel)(Args), int grid, int threads, int smem,
                     int cluster, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}

}  // namespace pathopt
