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
// are sequential within a scenario.
//
// What the design does about it: one block per scenario, thread k owns
// lateral k and scans kp = 0 .. K-1 in order with a strict `<` (ties go to
// the smallest kp). The frontier (cost, dir) lives in shared memory; one
// __syncthreads_or per layer both reduces "any cost < 1e30" and orders the
// frontier reads before the writes. Thread k reads dir[kp, k] and
// base[kp, k], so a warp's loads are contiguous.
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

__global__ void dp_forward_kernel(const float* __restrict__ dir_all,
                                  const float* __restrict__ base_all,
                                  const float* __restrict__ h_in,
                                  const float* __restrict__ cost0,
                                  const float* __restrict__ dir0,
                                  float* __restrict__ costs,
                                  int* __restrict__ parents,
                                  unsigned char* __restrict__ alives,
                                  int lm1, int K, float w1) {
  extern __shared__ float frontier[];
  float* cost_p = frontier;
  float* dir_p = frontier + K;
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool mine = k < K;
  if (mine) {
    cost_p[k] = cost0[static_cast<size_t>(b) * K + k];
    dir_p[k] = dir0[static_cast<size_t>(b) * K + k];
  }
  bool alive = true;
  __syncthreads();

  for (int l = 0; l < lm1; ++l) {
    const size_t layer = static_cast<size_t>(b) * lm1 + l;
    float best = kInf, best_dir = 0.f;
    int best_prev = 0;
    if (mine) {
      const float* d = dir_all + layer * K * K;
      const float* base = base_all + layer * K * K;
      for (int kp = 0; kp < K; ++kp) {
        const float dk = d[kp * K + k];
        const float t1 = __fmul_rn(
            __fdiv_rn(fabsf(wrap(__fsub_rn(dk, dir_p[kp]))), kHalfPi), w1);
        const float total =
            __fadd_rn(__fadd_rn(cost_p[kp], t1), base[kp * K + k]);
        if (kp == 0 || total < best) {
          best = total;
          best_prev = kp;
          best_dir = dk;
        }
      }
    }
    const bool any = __syncthreads_or(mine && best < kInf);
    const bool layer_alive = alive && any;
    if (mine) {
      const float cost_n = layer_alive ? best : kInf;
      const float dir_n = best < kInf ? best_dir : h_in[layer];
      costs[layer * K + k] = cost_n;
      parents[layer * K + k] = best_prev;
      cost_p[k] = cost_n;
      dir_p[k] = dir_n;
    }
    if (k == 0) alives[layer] = layer_alive ? 1 : 0;
    alive = layer_alive;
    __syncthreads();
  }
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success).
extern "C" int pathopt_dp_forward(const float* dir_all, const float* base_all,
                                  const float* h_in, const float* cost0,
                                  const float* dir0, float* costs,
                                  int* parents, unsigned char* alives,
                                  int batch, int lm1, int K, float w1,
                                  void* stream) {
  const int threads = ((K + 31) / 32) * 32;
  const size_t shmem = 2 * static_cast<size_t>(K) * sizeof(float);
  pathopt::dp_forward_kernel<<<batch, threads, shmem,
                               static_cast<cudaStream_t>(stream)>>>(
      dir_all, base_all, h_in, cost0, dir0, costs, parents, alives, lm1, K,
      w1);
  return pathopt::launch_status();
}
