// K4: the DP corridor search's forward pass over the lattice layers.
//
// Replaces: tpu_pathopt/corridor.py, _dp_fwd_kernel (wrapper
// _dp_forward_pallas, pallas_call at :370; dispatched by dp_forward_batched).
//
// For each layer l = 0 .. L-2, each lateral k:
//   total[kp] = cost_p[kp] + |wrap(dir[kp, k] - dir_p[kp])| / (pi/2) * w1
//               + base[kp, k],     wrap(x) = mod(x + pi, 2 pi) - pi
//   cost[k] = min_kp total, parent[k] = first argmin, dir[k] = the chosen
//   edge's direction (the layer's ref heading where cost >= 1e30).
// A layer is alive iff its predecessor is and any cost < 1e30; a dead
// layer's costs are all 1e30. Inputs are batch-leading: dir_all, base_all
// (B, L-1, K, K), h_in (B, L-1), cost0, dir0 (B, K); outputs costs (B, L-1,
// K) float32, parents (B, L-1, K) int32, alives (B, L-1) uint8.
//
// The result must be bit-identical to the plain PyTorch scan (parents and
// alive flags are compared exactly). So every operation is a single,
// correctly rounded float32 operation in the order of the JAX scan: mod is
// C fmodf plus a sign fix (exactly what jnp.mod and torch.remainder do), and
// the _rn intrinsics keep nvcc from contracting adds and multiplies into
// FMAs, which would flip near-tie parents.
//
// What bounds it on the H100: at the main path's shape (B = 256, L-1 = 31,
// K = 35) it reads 2 x 39 MB of edge tables once and does about 10 operations
// per edge, so the bytes bound it (about 23 us at 3.35 TB/s); the 31 layers
// are sequential within a scenario, so the latency of a layer's step
// bounds it: loading the tables, the scan and the barriers.
//
// What the design does about it: one block per scenario with K x P threads,
// thread (p, k) scanning slice p of the kp range for lateral k.
// - Staged tables: while layer l computes, layer l+1's two K x K tables
//   are copied into shared memory with 4-byte cp.async (a layer's table
//   starts at any 4-byte offset), double-buffered, by all threads
//   contiguously. The scan reads only shared memory.
// - Split scan: each slice is scanned in order with a strict `<`, then
//   thread (0, k) combines the P partial minima in slice order with a
//   strict `<`: with finite totals that is the full scan's first argmin
//   (smallest kp among equal totals). best_dir is read from the staged
//   table at the winning kp.
// - fmodf stays: an exact shortcut for |y| < 4 pi (y, or y - 2 pi by
//   Sterbenz's lemma) saved too little to keep (an A/B on the card,
//   PERF.md section 6).
// - Past K = 119 the two buffers no longer fit in shared memory (4 K^2
//   floats): the launcher then takes the same kernel's other template
//   branch, which reads each layer's tables straight from device memory
//   (neighbouring threads on neighbouring laterals, so each kp row is one
//   coalesced read). The scan, its order and its results are the same, so
//   it stays bit for bit equal to the plain version; K is at most 1024
//   (one thread per lateral, one slice each from K = 256).
// The frontier (cost, dir) lives in shared memory; __syncthreads_or both
// reduces "any cost < 1e30" and orders the frontier reads before the writes.
#include "common.cuh"

namespace pathopt {
namespace {

// float32 roundings of the Python doubles pi, 2 pi and pi / 2.
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInf = 1e30f;

__device__ __forceinline__ float wrap(float x) {
  float r = fmodf(__fadd_rn(x, kPi), kTwoPi);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, kTwoPi);
  return __fsub_rn(r, kPi);
}

// Staged: layer tables double-buffered in shared memory (K <= 119), else
// read from device memory. (No launch bounds: 29-32 registers a thread, so
// a block of 1024 threads fits the register file.)
template <bool Staged>
__global__ void dp_forward_kernel(const float* __restrict__ dir_all,
                  const float* __restrict__ base_all,
                  const float* __restrict__ h_in,
                  const float* __restrict__ cost0,
                  const float* __restrict__ dir0, float* __restrict__ costs,
                  int* __restrict__ parents,
                  unsigned char* __restrict__ alives, int lm1, int K, int P,
                  float w1) {
  extern __shared__ float smem[];
  const int KK = K * K;
  float* tables = smem;              // 2 buffers x (dir, base), K x K each
  float* cost_p = smem + (Staged ? 4 * KK : 0);  // the frontier
  float* dir_p = cost_p + K;
  float* part_cost = dir_p + K;      // (P, K) partial minima
  int* part_kp = reinterpret_cast<int*>(part_cost + P * K);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int k = t % K;
  const int p = t / K;
  const int slice = (K + P - 1) / P;
  const int kp0 = p * slice;
  const int kp1 = min(K, kp0 + slice);
  const bool scans = p < P && kp0 < kp1;
  const bool owner = t < K;          // thread (0, k) owns lateral k

  auto stage = [&](int l) {
    if (l < lm1) {
      const size_t layer = static_cast<size_t>(b) * lm1 + l;
      const float* d = dir_all + layer * KK;
      const float* bs = base_all + layer * KK;
      float* dst = tables + (l & 1) * 2 * KK;
      for (int e = t; e < KK; e += T) {
        cp_async4(dst + e, d + e);
        cp_async4(dst + KK + e, bs + e);
      }
    }
    cp_async_commit();
  };

  if (owner) {
    cost_p[k] = cost0[static_cast<size_t>(b) * K + k];
    dir_p[k] = dir0[static_cast<size_t>(b) * K + k];
  }
  if constexpr (Staged) stage(0);
  bool alive = true;

  for (int l = 0; l < lm1; ++l) {
    const float* d;
    const float* base;
    if constexpr (Staged) {
      stage(l + 1);
      cp_async_wait<1>();
      d = tables + (l & 1) * 2 * KK;
      base = d + KK;
    } else {
      d = dir_all + (static_cast<size_t>(b) * lm1 + l) * KK;
      base = base_all + (static_cast<size_t>(b) * lm1 + l) * KK;
    }
    __syncthreads();  // layer l's tables and the frontier are in place
    if (scans) {
      float best = 0.f;
      int best_prev = kp0;
      for (int kp = kp0; kp < kp1; ++kp) {
        const float t1 = __fmul_rn(
            __fdiv_rn(fabsf(wrap(__fsub_rn(d[kp * K + k], dir_p[kp]))),
                      kHalfPi),
            w1);
        const float total =
            __fadd_rn(__fadd_rn(cost_p[kp], t1), base[kp * K + k]);
        if (kp == kp0 || total < best) {
          best = total;
          best_prev = kp;
        }
      }
      part_cost[p * K + k] = best;
      part_kp[p * K + k] = best_prev;
    }
    __syncthreads();

    float best = kInf, best_dir = 0.f;
    int best_prev = 0;
    if (owner) {
      best = part_cost[k];
      best_prev = part_kp[k];
      for (int q = 1; q < P; ++q) {
        const float c = part_cost[q * K + k];
        if (c < best) {
          best = c;
          best_prev = part_kp[q * K + k];
        }
      }
      best_dir = d[best_prev * K + k];
    }
    const bool any = __syncthreads_or(owner && best < kInf);
    const bool layer_alive = alive && any;
    const size_t layer = static_cast<size_t>(b) * lm1 + l;
    if (owner) {
      const float cost_n = layer_alive ? best : kInf;
      const float dir_n = best < kInf ? best_dir : h_in[layer];
      costs[layer * K + k] = cost_n;
      parents[layer * K + k] = best_prev;
      cost_p[k] = cost_n;
      dir_p[k] = dir_n;
    }
    if (t == 0) alives[layer] = layer_alive ? 1 : 0;
    alive = layer_alive;
  }
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). The block has K x P
// threads, P = the number of slices of each lateral's kp scan, chosen so
// that K x P is at most about 256 (no slice empty), and shared memory for
// the frontier, the P partial minima of each lateral and, where they fit
// in the card's shared memory (K <= 119), two layers' tables; a larger
// lattice reads its tables from device memory. K above 1024 is refused
// with cudaErrorInvalidValue without running.
extern "C" int pathopt_dp_forward(const float* dir_all, const float* base_all,
                                  const float* h_in, const float* cost0,
                                  const float* dir0, float* costs,
                                  int* parents, unsigned char* alives,
                                  int batch, int lm1, int K, float w1,
                                  void* stream) {
  if (batch < 1 || lm1 < 1 || K < 1 || K > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  int slices = K < 256 ? 256 / K : 1;
  if (slices > K) slices = K;
  slices = (K + (K + slices - 1) / slices - 1) / ((K + slices - 1) / slices);
  const size_t rest = (2 * static_cast<size_t>(K) +
                       2 * static_cast<size_t>(slices) * K) * sizeof(float);
  const size_t tables = 4 * static_cast<size_t>(K) * K * sizeof(float);
  const bool staged =
      tables + rest <= static_cast<size_t>(pathopt::kMaxSmemBytes);
  const int smem_bytes = static_cast<int>(staged ? tables + rest : rest);
  const int threads = (slices * K + 31) / 32 * 32;
  auto kernel = staged ? pathopt::dp_forward_kernel<true>
                       : pathopt::dp_forward_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<batch, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      dir_all, base_all, h_in, cost0, dir0, costs, parents, alives, lm1, K,
      slices, w1);
  return pathopt::launch_status();
}
