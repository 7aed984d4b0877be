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
// C fmodf, or its exact shortcut (wrap), plus a sign fix (exactly what
// jnp.mod and torch.remainder do), and
// the _rn intrinsics keep nvcc from contracting adds and multiplies into
// FMAs, which would flip near-tie parents. Any order of combining partial
// minima that keeps, among equal totals, the smallest kp gives the same
// first argmin; each combine below does.
//
// What bounds it on the H100: each edge is read once (two tables of B (L-1)
// K^2 floats: 2 x 39 MB at the main path's B = 256, L-1 = 31, K = 35, 2 x
// 580 MB at the fine lattice's K = 135) with about 11 operations on it, so
// the bytes bound it (0.024 ms and 0.348 ms at 3.35 TB/s). The layers are
// sequential within a scenario, so a layer's latency counts: loading its
// tables, the scan (an IEEE division and a wrap an edge) and the barriers.
//
// What the design does about it: two plans, chosen in Python
// (corridor.dp_plan) and checked here.
// - Staged (K <= 119, one CTA a scenario, K x P threads, thread (p, k)
//   scanning slice p of the kp range): while layer l computes, layer
//   l+1's two K x K tables are copied into shared memory with 4-byte
//   cp.async (a layer's table starts at any 4-byte offset),
//   double-buffered, by all threads contiguously. Each slice is scanned in
//   order with a strict `<`, then thread (0, k) combines the P partial
//   minima in slice order with a strict `<`; best_dir is read from the
//   staged table at the winning kp.
// - Streamed (K > 119, where two layers no longer fit, or any K with a
//   cluster size forced): a scenario's tables are two streams of (L-1) K
//   kp rows that do not depend on the DP frontier, so they flow through a
//   ring of `depth` chunks of `rows` kp rows in shared memory, each table's
//   chunk one bulk copy (TMA) on the slot's mbarrier, issued by warp 0
//   depth - 1 chunks ahead and across layer boundaries; a chunk's start is
//   4-byte aligned only, so the copy takes its 16-byte-aligned interior in
//   bulk and the at most 3 floats on each side with cp.async, and the slot
//   keeps the source's offset within 16 bytes. Each warp frees a slot on
//   its empty mbarrier. Lateral k has P (a power of two) adjacent lanes;
//   lane p scans rows p, p + P, ... of each chunk (ascending kp, a strict
//   `<`, carrying the edge's direction), and the P lanes combine by
//   shuffles keeping, among equal totals, the smaller kp. A layer ends with
//   one __syncthreads_or (the alive flag, which also publishes the next
//   frontier, double-buffered). Where B leaves SMs idle a scenario takes a
//   thread block cluster of c CTAs, rank j streaming kp rows [j kr, j kr +
//   kr), kr = ceil(K / c); each CTA writes its partial minima of a layer,
//   and after a cluster barrier every CTA combines the ranks in order with
//   a strict `<` through DSMEM (double-buffered, one cluster barrier a
//   layer), so each holds the whole frontier and the alive flag; rank j
//   writes laterals [j kr, j kr + kr) of the outputs.
// K is at most 1024 (one thread a lateral at P = 1).
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace pathopt {
namespace {

namespace cg = cooperative_groups;

// float32 roundings of the Python doubles pi, 2 pi and pi / 2.
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInf = 1e30f;

// The streamed plan's limits (corridor.DP_MAX_CLUSTER, DP_MAX_DEPTH).
constexpr int kDpMaxCluster = 8;
constexpr int kDpMaxDepth = 8;
constexpr int kDpMaxThreads = 1024;
// Arrivals that complete a chunk's full barrier: lane 0 of warp 0 expecting
// the bulk bytes, and each of warp 0's 32 lanes once its cp.async copies of
// the chunk's unaligned ends have landed.
constexpr unsigned kFullArrivals = 33;

// mod(x + pi, 2 pi) - pi. fmod(y, 2 pi) is y for |y| < 2 pi and y -+ 2 pi,
// exact by Sterbenz's lemma, for |y| < 4 pi: the only cases a lattice's
// directions (atan2, within pi) give, unless a reference heading lies far
// outside; fmodf takes the rest. (At y = -2 pi this gives +0 where fmodf
// gives -0; either becomes -pi below.)
__device__ __forceinline__ float wrap(float x) {
  const float y = __fadd_rn(x, kPi);
  const float ay = fabsf(y);
  float r;
  if (ay < kTwoPi)
    r = y;
  else if (ay < 2.f * kTwoPi)
    r = __fsub_rn(y, copysignf(kTwoPi, y));
  else
    r = fmodf(y, kTwoPi);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, kTwoPi);
  return __fsub_rn(r, kPi);
}

// The cost of the edge kp -> k: cost_p + t1 + base, in the scan's order.
__device__ __forceinline__ float edge_total(float cost_p, float dir_p,
                                           float d, float base, float w1) {
  const float t1 =
      __fmul_rn(__fdiv_rn(fabsf(wrap(__fsub_rn(d, dir_p))), kHalfPi), w1);
  return __fadd_rn(__fadd_rn(cost_p, t1), base);
}

// ------------------------------- staged -------------------------------------

// Layer tables double-buffered in shared memory (K <= 119). (No launch
// bounds: 29-32 registers a thread, so a block of 1024 threads fits the
// register file.)
__global__ void dp_forward_staged(const float* __restrict__ dir_all,
                                  const float* __restrict__ base_all,
                                  const float* __restrict__ h_in,
                                  const float* __restrict__ cost0,
                                  const float* __restrict__ dir0,
                                  float* __restrict__ costs,
                                  int* __restrict__ parents,
                                  unsigned char* __restrict__ alives, int lm1,
                                  int K, int P, float w1) {
  extern __shared__ float smem[];
  const int KK = K * K;
  float* tables = smem;              // 2 buffers x (dir, base), K x K each
  float* cost_p = smem + 4 * KK;     // the frontier
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
  stage(0);
  bool alive = true;

  for (int l = 0; l < lm1; ++l) {
    stage(l + 1);
    cp_async_wait<1>();
    const float* d = tables + (l & 1) * 2 * KK;
    const float* base = d + KK;
    __syncthreads();  // layer l's tables and the frontier are in place
    if (scans) {
      float best = 0.f;
      int best_prev = kp0;
      for (int kp = kp0; kp < kp1; ++kp) {
        const float total =
            edge_total(cost_p[kp], dir_p[kp], d[kp * K + k],
                       base[kp * K + k], w1);
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

// ------------------------------- streamed -----------------------------------

struct StreamArgs {
  const float* dir_all;
  const float* base_all;
  const float* h_in;
  const float* cost0;
  const float* dir0;
  float* costs;
  int* parents;
  unsigned char* alives;
  int lm1, K, P, rows, depth;
  float w1;
};

// Floats of one table's region of a ring slot: rows x K rounded up to
// whole 16-byte units, and 4 more, since a chunk keeps its source's offset
// within 16 bytes (corridor.dp_smem_bytes).
__host__ __device__ constexpr int region_floats(int rows, int K) {
  return (rows * K + 3) / 4 * 4 + 4;
}

inline size_t streamed_smem_bytes(int K, int cluster, int rows, int depth) {
  const size_t slot = 2 * static_cast<size_t>(region_floats(rows, K)) + 4;
  return (depth * slot + 4 * static_cast<size_t>(K) +
          (cluster > 1 ? 6 * static_cast<size_t>(K) : 0)) *
         sizeof(float);
}

// A chunk of n floats at src, as the ring copies it: `head` floats up to
// the first 16-byte boundary, `body` floats in bulk (a multiple of 4), then
// `tail` (< 4); `m`, src's offset within 16 bytes in floats, is where the
// chunk starts in its region, so the body lands 16-byte aligned there too.
struct Split {
  int m, head, body, tail;
};

// The offset of src within 16 bytes, in floats.
__device__ __forceinline__ int offset16(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
}

__device__ __forceinline__ Split split_chunk(const float* src, int n) {
  Split s;
  s.m = offset16(src);
  s.head = min(n, (4 - s.m) & 3);
  s.body = (n - s.head) & ~3;
  s.tail = n - s.head - s.body;
  return s;
}

// Warp 0's lanes 6 t .. 6 t + 5 copy the head (lanes + 0..2) and the tail
// (+ 3..5) of table t's chunk with cp.async.
__device__ __forceinline__ void copy_ends(float* region, const float* src,
                                          const Split& s, int e) {
  if (e < 3) {
    if (e < s.head) cp_async4(region + s.m + e, src + e);
  } else if (e - 3 < s.tail) {
    const int i = s.head + s.body + e - 3;
    cp_async4(region + s.m + i, src + i);
  }
}

// One CTA (or, with Cluster, one CTA of a scenario's cluster) of the
// streamed plan; thread t = k P + p.
template <bool Cluster>
__global__ void __launch_bounds__(kDpMaxThreads)
    dp_forward_streamed(const StreamArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, P = a.P, R = a.rows, D = a.depth, lm1 = a.lm1;
  const int Q = region_floats(R, K);
  float* ring = smem;                                  // D x (dir, base)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * D * Q);
  uint64_t* empty = full + D;
  float* fcost = smem + 2 * D * Q + 4 * D;             // 2 x K, the frontier
  float* fdir = fcost + 2 * K;                         // 2 x K
  float* xbest = fdir + 2 * K;                         // 2 x K, a cluster's
  int* xkp = reinterpret_cast<int*>(xbest + 2 * K);    // partial minima
  float* xdir = xbest + 4 * K;

  int rank = 0, size = 1, b = blockIdx.x;
  if constexpr (Cluster) {
    const cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    size = static_cast<int>(cl.num_blocks());
    b = blockIdx.x / size;
  }
  const int kr = (K + size - 1) / size;
  const int row_lo = rank * kr;            // this CTA's kp rows
  const int nr = min(kr, K - row_lo);
  const int nch = (nr + R - 1) / R;        // chunks a layer
  const int total = lm1 * nch;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k = t / P;
  const int p = t - k * P;
  const bool active = k < K;
  const bool owner = active && p == 0;
  const size_t scen = static_cast<size_t>(b) * lm1;

  if (t == 0) {
    for (int s = 0; s < D; ++s) {
      barrier_init(full + s, kFullArrivals);
      barrier_init(empty + s, blockDim.x / 32);
    }
    fence_barrier_init();
  }
  for (int i = t; i < K; i += blockDim.x) {
    fcost[i] = a.cost0[static_cast<size_t>(b) * K + i];
    fdir[i] = a.dir0[static_cast<size_t>(b) * K + i];
  }
  __syncthreads();

  // Chunk q of this CTA's stream: layer q / nch, local rows from
  // (q % nch) R; its offset in either table.
  auto chunk_offset = [&](int q, int& len) {
    const int l = q / nch;
    const int row = (q - l * nch) * R;
    len = min(R, nr - row);
    return ((scen + l) * K + row_lo + row) * K;
  };
  // Warp 0: chunk q into slot q % D, once every warp has freed the slot.
  auto issue = [&](int q) {
    if (q >= total) return;
    const int s = q % D;
    if (q >= D) barrier_wait(empty + s, ((q / D) - 1) & 1);
    int len;
    const size_t off = chunk_offset(q, len);
    const int n = len * K;
    const float* src_d = a.dir_all + off;
    const float* src_b = a.base_all + off;
    const Split sd = split_chunk(src_d, n), sb = split_chunk(src_b, n);
    float* reg_d = ring + s * 2 * Q;
    float* reg_b = reg_d + Q;
    if (lane == 0) {
      expect_bytes(full + s,
                   static_cast<unsigned>((sd.body + sb.body) * sizeof(float)));
      if (sd.body)
        bulk_copy(reg_d + sd.m + sd.head, src_d + sd.head,
                  static_cast<unsigned>(sd.body * sizeof(float)), full + s);
      if (sb.body)
        bulk_copy(reg_b + sb.m + sb.head, src_b + sb.head,
                  static_cast<unsigned>(sb.body * sizeof(float)), full + s);
    }
    if (lane < 6)
      copy_ends(reg_d, src_d, sd, lane);
    else if (lane < 12)
      copy_ends(reg_b, src_b, sb, lane - 6);
    cp_async_arrive(full + s);
  };

  if (warp == 0)
    for (int q = 0; q < D - 1; ++q) issue(q);
  bool alive = true;
  int q = 0;
  for (int l = 0; l < lm1; ++l) {
    const float h = owner ? a.h_in[scen + l] : 0.f;
    const float* fc = fcost + (l & 1) * K;
    const float* fd = fdir + (l & 1) * K;
    float best = __int_as_float(0x7f800000);  // +inf: no row yet
    int best_kp = INT_MAX;
    float best_d = 0.f;
    for (int j = 0; j < nch; ++j, ++q) {
      if (warp == 0) issue(q + D - 1);
      const int s = q % D;
      barrier_wait(full + s, (q / D) & 1);
      int len;
      const size_t off = chunk_offset(q, len);
      const int row = row_lo + j * R;
      const float* cd = ring + s * 2 * Q + offset16(a.dir_all + off);
      const float* cb = ring + s * 2 * Q + Q + offset16(a.base_all + off);
      if (active) {
#pragma unroll 4
        for (int i = p; i < len; i += P) {
          const int kp = row + i;
          const float d = cd[i * K + k];
          const float total = edge_total(alive ? fc[kp] : kInf, fd[kp], d,
                                         cb[i * K + k], a.w1);
          if (total < best) {
            best = total;
            best_kp = kp;
            best_d = d;
          }
        }
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(empty + s);
    }
    // The P lanes of lateral k: among equal totals the smaller kp.
    for (int o = P >> 1; o > 0; o >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, o);
      const int okp = __shfl_down_sync(0xffffffffu, best_kp, o);
      const float od = __shfl_down_sync(0xffffffffu, best_d, o);
      if (ob < best || (ob == best && okp < best_kp)) {
        best = ob;
        best_kp = okp;
        best_d = od;
      }
    }
    if constexpr (Cluster) {
      const int buf = (l & 1) * K;
      if (owner) {
        xbest[buf + k] = best;
        xkp[buf + k] = best_kp;
        xdir[buf + k] = best_d;
      }
      cg::this_cluster().sync();
      if (owner) {  // the ranks in kp order, a strict `<`
        const cg::cluster_group cl = cg::this_cluster();
        best = __int_as_float(0x7f800000);
        for (int r = 0; r < size; ++r) {
          const float rb = *cl.map_shared_rank(xbest + buf + k, r);
          if (rb < best) {
            best = rb;
            best_kp = *cl.map_shared_rank(xkp + buf + k, r);
            best_d = *cl.map_shared_rank(xdir + buf + k, r);
          }
        }
      }
    }
    // The next layer's frontier, published by the barrier that reduces
    // "any cost < 1e30"; its costs are read as 1e30 once a layer is dead.
    if (owner) {
      fcost[((l + 1) & 1) * K + k] = best;
      fdir[((l + 1) & 1) * K + k] = best < kInf ? best_d : h;
    }
    const bool layer_alive = __syncthreads_or(owner && best < kInf) && alive;
    if (owner && k >= row_lo && k < row_lo + nr) {
      const size_t layer = scen + l;
      a.costs[layer * K + k] = layer_alive ? best : kInf;
      a.parents[layer * K + k] = best_kp;
    }
    if (rank == 0 && t == 0) a.alives[scen + l] = layer_alive ? 1 : 0;
    alive = layer_alive;
  }
  // No CTA leaves while a peer may still read its partial minima.
  if constexpr (Cluster) cg::this_cluster().sync();
}

int launch_staged(const StreamArgs& a, int batch, int slices, int smem_bytes,
                  cudaStream_t stream) {
  const int K = a.K;
  int want = K < 256 ? 256 / K : 1;
  if (want > K) want = K;
  want = (K + (K + want - 1) / want - 1) / ((K + want - 1) / want);
  const size_t smem = (4 * static_cast<size_t>(K) * K + 2 * K +
                       2 * static_cast<size_t>(want) * K) * sizeof(float);
  if (slices != want || smem != static_cast<size_t>(smem_bytes) ||
      smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dp_forward_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (slices * K + 31) / 32 * 32;
  dp_forward_staged<<<batch, threads, smem_bytes, stream>>>(
      a.dir_all, a.base_all, a.h_in, a.cost0, a.dir0, a.costs, a.parents,
      a.alives, a.lm1, K, slices, a.w1);
  return launch_status();
}

// 0 if (K, cluster, P, rows, depth, smem_bytes) is a streamed plan the
// kernel takes, else cudaErrorInvalidValue.
int streamed_plan_error(int K, int cluster, int P, int rows, int depth,
                        int smem_bytes) {
  const int kr = cluster > 0 ? (K + cluster - 1) / cluster : 0;
  const int threads = (K * P + 31) / 32 * 32;
  if (K < 1 || K > 1024 || cluster < 1 || cluster > kDpMaxCluster ||
      (cluster - 1) * kr >= K || P < 1 || P > 32 || (P & (P - 1)) != 0 ||
      threads > kDpMaxThreads || rows < 1 || rows > kr || depth < 2 ||
      depth > kDpMaxDepth ||
      static_cast<size_t>(smem_bytes) !=
          streamed_smem_bytes(K, cluster, rows, depth) ||
      smem_bytes > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The streamed kernel for `cluster`, given `smem_bytes` of dynamic shared
// memory and the most shared memory an SM has (several CTAs may share an
// SM); null if the card refuses, with the error in err.
using StreamKernel = void (*)(StreamArgs);
StreamKernel streamed_kernel(int cluster, int smem_bytes, int& err) {
  const StreamKernel kernel = cluster == 1 ? dp_forward_streamed<false>
                                           : dp_forward_streamed<true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  err = static_cast<int>(e);
  return e == cudaSuccess ? kernel : nullptr;
}

int launch_streamed(const StreamArgs& a, int batch, int cluster,
                    int smem_bytes, cudaStream_t stream) {
  int err = streamed_plan_error(a.K, cluster, a.P, a.rows, a.depth,
                                smem_bytes);
  if (err) return err;
  const StreamKernel kernel = streamed_kernel(cluster, smem_bytes, err);
  if (err) return err;
  const int threads = (a.K * a.P + 31) / 32 * 32;
  if (cluster > 1)
    return launch_clustered(kernel, batch * cluster, threads, smem_bytes,
                            cluster, a, stream);
  kernel<<<batch, threads, smem_bytes, stream>>>(a);
  return launch_status();
}

}  // namespace
}  // namespace pathopt

// How many clusters (c > 1) or CTAs (c = 1) of a streamed plan the current
// card holds at once, into *held: what corridor.dp_plan weighs the cluster
// sizes by. Returns the cudaError_t of the query (a plan the kernel does
// not take: cudaErrorInvalidValue).
extern "C" int pathopt_dp_resident(int K, int cluster, int slices, int rows,
                                   int depth, int smem_bytes, int* held) {
  int err = pathopt::streamed_plan_error(K, cluster, slices, rows, depth,
                                         smem_bytes);
  if (err) return err;
  const auto kernel = pathopt::streamed_kernel(cluster, smem_bytes, err);
  if (err) return err;
  const int threads = (K * slices + 31) / 32 * 32;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
    *held = sms * per_sm;
    return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(held, kernel, &cfg));
}

// Returns the cudaError_t of the launch (0 on success). The plan comes from
// corridor.dp_plan: `staged` (one CTA a scenario, K x slices threads, two
// layers' tables in shared memory; slices and smem_bytes must be the
// staged formula's), else the streamed plan (clusters of `cluster` CTAs,
// `slices` a power of two, rings of `depth` chunks of `rows` kp rows,
// smem_bytes = streamed_smem_bytes). A plan that breaks these rules, or K
// outside 1 .. 1024, is refused with cudaErrorInvalidValue without
// running; a cluster the card cannot hold with
// cudaErrorLaunchOutOfResources.
extern "C" int pathopt_dp_forward(const float* dir_all, const float* base_all,
                                  const float* h_in, const float* cost0,
                                  const float* dir0, float* costs,
                                  int* parents, unsigned char* alives,
                                  int batch, int lm1, int K, int staged,
                                  int cluster, int slices, int rows,
                                  int depth, int smem_bytes, float w1,
                                  void* stream) {
  if (batch < 1 || lm1 < 1 || K < 1 || K > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const pathopt::StreamArgs a{dir_all, base_all, h_in,  cost0, dir0,
                              costs,   parents,  alives, lm1,  K,
                              slices,  rows,     depth,  w1};
  const auto st = static_cast<cudaStream_t>(stream);
  if (staged)
    return cluster == 1
               ? pathopt::launch_staged(a, batch, slices, smem_bytes, st)
               : static_cast<int>(cudaErrorInvalidValue);
  return pathopt::launch_streamed(a, batch, cluster, smem_bytes, st);
}
