// Device functions shared by the ADMM-round kernels K2 and K3: one thread
// per knot, the round resident in shared memory and registers. A scenario
// takes one thread block (CTA) or, past what one CTA holds, a thread block
// cluster of c CTAs (c <= 8): CTA rank j holds knots [j k, j k + k) in its
// own shared memory and reads its neighbours' edge knots through
// distributed shared memory (Hopper's DSMEM).
//
// The block-tridiagonal solve of every iteration,
//   y_i  = Cinv_i (rhs_i - W_i y_{i-1})            forward sweep
//   vt_i = Cinv_i^T (y_i - W_{i+1}^T vt_{i+1})     backward sweep,
// is reassociated so that each sequential step is one nb x nb matvec:
//   G_i = Cinv_i W_i,  H_i = Cinv_i^T W_{i+1}^T    once per launch
//   d_i = Cinv_i rhs_i                             parallel over knots
//   y_i = d_i - G_i y_{i-1}                        sequential
//   e_i = Cinv_i^T y_i                             parallel over knots
//   vt_i = e_i - H_i vt_{i+1}                      sequential
// with G_0 = H_{n-1} = 0. Lanes 0..nb-1 of warp 0 walk the knots, lane r
// owning row r; the previous step's vector reaches every lane by
// __shfl_sync. In a cluster the CTAs walk their runs in turn, rank 0 up on
// the way forward and down on the way back, with a cluster barrier between
// turns: each starts from its neighbour's edge knot, the same float the
// one-CTA walk carries in a register, so the steps, their order and their
// results do not depend on c.
//
// What bounds a cluster launch is how many scenarios' walks the card holds
// at once: a scenario's CTAs keep its whole round resident while only 6
// lanes walk, so a launch of more scenarios than fit runs in waves, each
// as long as one scenario's walk. So the cluster instantiation keeps G and
// H out of shared memory (72 of K2's 123 floats a knot): each CTA writes
// its knots' blocks once to a scratch buffer in device memory (the
// wrapper's, (2, B, n, bs) with bs = nb^2 rounded up to 4 floats), and
// the walk reads them back through a ring of kRingChunks chunks of
// kChunkKnots blocks in shared memory, each chunk one bulk copy (TMA)
// that completes on its own mbarrier, started kRingChunks - 1 chunks ahead;
// the walk over a full chunk is unrolled. Each kernel's cluster entry point
// is also built for fewer registers than its one-CTA one (__launch_bounds__
// with a count of CTAs an SM should hold), and its launches ask for the
// SM's largest shared-memory carveout. The one-CTA kernels keep every
// block in shared memory, as below, and their code.
//
// Shared memory of one CTA, in floats, for k knots per CTA:
//   ring  (kRingChunks, kChunkKnots, bs)   a cluster only: the walk's blocks
//   bars  kRingChunks mbarriers (8 bytes)  a cluster only: one a chunk
//   G, H  (k, nb, nb) row-major per knot   one CTA only: read by the walk
//   D     (k, nb)                          d, then y, then e, then vt
//   X     (nb, k)                          a vector handed to knot i-1
//   ci    (nb (nb + 1) / 2, k)             lower triangle of Cinv_i
// then the kernel's own per-knot blocks ((e, k) element-major, so thread i
// reading element e of its knot hits bank (e k + i) mod 32 without
// conflicts) and a fixed tail. fused_rounds.round_smem_bytes and
// fused_rounds.round_plan in Python compute the same sizes and plan; the
// launchers refuse any other.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace pathopt {

namespace cg = cooperative_groups;

// One thread per knot: at most this many knots per CTA. With 256 threads the
// compiler may give each thread up to 255 registers (at 512, 128).
constexpr int kMaxRoundThreads = 256;
constexpr int kMaxRoundWarps = kMaxRoundThreads / 32;
// The most CTAs of one cluster that every Hopper part schedules (portable).
constexpr int kMaxClusterSize = 8;
// A cluster CTA's ring: kRingChunks chunks of kChunkKnots knots' blocks;
// the walk reads chunk q while chunks q + 1 .. q + kRingChunks - 1 load.
constexpr int kChunkKnots = 16;
constexpr int kRingChunks = 2;

__host__ __device__ constexpr int tri_size(int nb) { return nb * (nb + 1) / 2; }

// (r, j), j <= r, of a lower triangle packed by rows.
__host__ __device__ constexpr int tri(int r, int j) { return r * (r + 1) / 2 + j; }

inline int round_threads(int n) { return (n + 31) / 32 * 32; }

// Floats between two knots' blocks in a cluster's scratch and ring: nb^2
// rounded up to whole 16-byte units, as the bulk copies need.
__host__ __device__ constexpr int block_stride(int nb) {
  return (nb * nb + 3) / 4 * 4;
}

// Shared memory of one CTA holding n knots: the one-CTA layout, or with
// `streamed` a cluster CTA's (G and H in device memory, the ring here).
inline size_t round_smem_bytes(int n, int nb, int knot_floats,
                               int tail_floats, bool streamed) {
  const size_t blocks = streamed ? 0 : 2 * nb * nb;
  const size_t per_knot = blocks + 2 * nb + tri_size(nb) + knot_floats;
  const size_t ring =
      streamed ? kRingChunks * (kChunkKnots * block_stride(nb) + 2) : 0;
  return (per_knot * n + tail_floats + ring) * sizeof(float);
}

// A round's launch plan: c CTAs per scenario (a cluster when c > 1), k
// knots per CTA (rank j holds knots [j k, min(n, j k + k))) and the shared
// memory of one CTA. cluster == 0: no plan.
struct RoundPlan {
  int cluster;
  int knots;
  size_t smem;
};

// The plan for n knots: the smallest c in 1..kMaxClusterSize whose CTAs
// hold k = ceil(n / c) knots each in at most kMaxRoundThreads threads and
// kMaxSmemBytes bytes (the one-CTA layout at c = 1, the streamed one
// above) with no CTA left empty, or exactly c = `forced` when forced > 0.
// Past one CTA the smallest c is also the most resident: the registers
// bind (the cluster kernels' __launch_bounds__), and k = ceil(n / c)
// wastes the fewest threads to a ragged last warp. Twin of
// fused_rounds.round_plan.
inline RoundPlan round_plan(int n, int nb, int knot_floats, int tail_floats,
                            int forced) {
  const int lo = forced > 0 ? forced : 1;
  const int hi = forced > 0 ? forced : kMaxClusterSize;
  for (int c = lo; n >= 1 && c <= hi && c <= kMaxClusterSize; ++c) {
    const int k = (n + c - 1) / c;
    const size_t smem =
        round_smem_bytes(k, nb, knot_floats, tail_floats, c > 1);
    if (round_threads(k) <= kMaxRoundThreads && smem <= kMaxSmemBytes &&
        (c - 1) * k < n)
      return RoundPlan{c, k, smem};
  }
  return RoundPlan{0, 0, 0};
}

// The launch configuration check: 0 if the caller's plan (cluster, knots,
// smem_bytes) is the plan round_plan gives and a cluster plan has its
// scratch buffer, else the error to return without launching.
inline int round_config_error(const RoundPlan& plan, int batch, int cluster,
                              int knots, int smem_bytes,
                              const float* scratch) {
  if (plan.cluster < 1 || batch < 1 || plan.cluster != cluster ||
      plan.knots != knots || plan.smem != static_cast<size_t>(smem_bytes) ||
      (plan.cluster > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Launch a round kernel on its plan: the one-CTA instantiation with a plain
// launch at c = 1, else the cluster instantiation over batch x c CTAs in
// clusters of c, after checking that a cluster of them fits on the card.
template <class Args>
int launch_round(void (*one)(Args), void (*clustered)(Args),
                 const RoundPlan& plan, int batch, const Args& a,
                 cudaStream_t stream) {
  auto kernel = plan.cluster == 1 ? one : clustered;
  const int smem = static_cast<int>(plan.smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = round_threads(plan.knots);
  if (plan.cluster == 1) {
    kernel<<<batch, threads, smem, stream>>>(a);
    return launch_status();
  }
  return launch_clustered(kernel, batch * plan.cluster, threads, smem,
                          plan.cluster, a, stream);
}

// The knots of one scenario that this CTA holds. Without a cluster the
// CTA is the scenario: rank 0 of 1 with k = count = n, as the compiler
// sees, so the one-CTA kernel's indexing is the plain kernel's.
template <bool Cluster>
struct Span {
  int k;      // knots per CTA: the stride of the element-major arrays
  int rank;   // this CTA's rank in its cluster
  int size;   // CTAs per scenario
  int base;   // global index of this CTA's first knot
  int count;  // knots this CTA holds (1..k)
  int b;      // the scenario
  // n: the scenario's knots; k_: knots per CTA (the launch plan's)
  __device__ Span(int n, int k_) {
    if constexpr (Cluster) {
      const cg::cluster_group cl = cg::this_cluster();
      k = k_;
      rank = static_cast<int>(cl.block_rank());
      size = static_cast<int>(cl.num_blocks());
      b = blockIdx.x / size;
      base = rank * k;
      count = min(k, n - base);
    } else {
      k = n;
      rank = 0;
      size = 1;
      b = blockIdx.x;
      base = 0;
      count = n;
    }
  }
};

// A barrier between phases that exchange knots: the CTA's, or the
// cluster's when the exchange crosses CTAs.
template <bool Cluster>
__device__ __forceinline__ void knot_sync() {
  if constexpr (Cluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// `p`, a pointer into this CTA's shared memory, at the same offset in the
// shared memory of CTA `rank` of the cluster.
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  using U = std::remove_const_t<T>;
  return cg::this_cluster().map_shared_rank(const_cast<U*>(p), rank);
}

// Column il + 1 of an element-major (rows, k) array (element e at
// [e k]): the next knot's, from the next CTA when il is this CTA's last.
// Read it only for a knot whose successor exists (global index < n - 1).
template <bool Cluster>
__device__ __forceinline__ const float* next_col(const Span<Cluster>& sp,
                                                 const float* X, int il) {
  if constexpr (Cluster) {
    if (il + 1 == sp.count && sp.rank + 1 < sp.size)
      return peer(X, sp.rank + 1);
  }
  return X + il + 1;
}

// Row il - 1 of a knot-major (k, nb) array: the previous knot's, from the
// previous CTA when il is this CTA's first. Read it only for a knot with a
// predecessor (global index > 0).
template <bool Cluster>
__device__ __forceinline__ const float* prev_row(const Span<Cluster>& sp,
                                                 const float* D, int il,
                                                 int nb) {
  if constexpr (Cluster) {
    if (il == 0 && sp.rank > 0) return peer(D, sp.rank - 1) + (sp.k - 1) * nb;
  }
  return D + (il - 1) * nb;
}

// The round's arrays for one CTA (s: its dynamic shared memory). Without
// a cluster G and H sit in shared memory; in a cluster they point at this
// CTA's first knot in the launch's scratch (2, B, n, bs) in device memory,
// and the walk reads them through `ring`.
template <int NB, bool Cluster>
struct SweepSmem {
  // floats from one knot's G (or H) to the next's
  static constexpr int kStride = Cluster ? block_stride(NB) : NB * NB;
  float* G;
  float* H;
  float* D;
  float* X;
  float* ci;
  float* ring;
  uint64_t* bars;
  float* rest;  // the kernel's own blocks
  // n: the scenario's knots, batch: the launch's scenarios
  __device__ SweepSmem(float* s, const Span<Cluster>& sp, int n, int batch,
                       float* scratch) {
    const int k = sp.k;
    if constexpr (Cluster) {
      G = scratch + (static_cast<size_t>(sp.b) * n + sp.base) * kStride;
      H = scratch +
          (static_cast<size_t>(batch + sp.b) * n + sp.base) * kStride;
      ring = s;
      s += kRingChunks * kChunkKnots * kStride;
      bars = reinterpret_cast<uint64_t*>(s);
      s += 2 * kRingChunks;
    } else {
      G = s;
      H = s + NB * NB * k;
      ring = nullptr;
      bars = nullptr;
      s += 2 * NB * NB * k;
    }
    D = s;
    X = s + NB * k;
    ci = s + 2 * NB * k;
    rest = s + (2 * NB + tri_size(NB)) * k;
  }
};

// Called by every thread of a cluster CTA after it has written its knots'
// G and H and before the barrier that ends the load phase: orders those
// writes before the ring's bulk copies, and sets up the ring's barriers.
template <int NB, bool Cluster>
__device__ __forceinline__ void ready_ring(const SweepSmem<NB, Cluster>& S) {
  if constexpr (Cluster) {
    fence_async();
    if (threadIdx.x == 0) {
      for (int q = 0; q < kRingChunks; ++q) barrier_init(S.bars + q);
      fence_barrier_init();
    }
  }
}

// Load local knot i's Cinv (its lower triangle) from device memory, where
// element (r, c) sits at ci_g[(r NB + c) stride], into registers and shared
// memory (n: the CTA's stride k),
// and store G_i = Cinv_i Wp_i and H_i = Cinv_i^T Wp_{i+1}^T (a null Wp gives
// the zero block). One column of G and one row of Wp_{i+1} at a time, so
// that only NB of the Wp values are live at once.
template <int NB, bool C>
__device__ void load_knot_factors(const SweepSmem<NB, C>& S, int n, int i,
                                  const float* ci_g, const float* wp_i,
                                  const float* wp_n, size_t stride) {
  float cl[tri_size(NB)];
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int j = 0; j <= r; ++j) {
      cl[tri(r, j)] = ci_g[(r * NB + j) * stride];
      S.ci[tri(r, j) * n + i] = cl[tri(r, j)];
    }
  float* G = S.G + i * S.kStride;
  float* H = S.H + i * S.kStride;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float w[NB];  // column c of Wp_i
#pragma unroll
    for (int j = 0; j < NB; ++j)
      w[j] = wp_i ? wp_i[(j * NB + c) * stride] : 0.f;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float g = cl[tri(r, 0)] * w[0];
#pragma unroll
      for (int j = 1; j <= r; ++j) g = g + cl[tri(r, j)] * w[j];
      G[r * NB + c] = g;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)  // row c of Wp_{i+1}
      w[j] = wp_n ? wp_n[(c * NB + j) * stride] : 0.f;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float h = cl[tri(r, r)] * w[r];
#pragma unroll
      for (int j = r + 1; j < NB; ++j) h = h + cl[tri(j, r)] * w[j];
      H[r * NB + c] = h;
    }
  }
}

// D_i = Cinv_i x (knot i's thread).
template <int NB, bool C>
__device__ __forceinline__ void store_ci_mul(const SweepSmem<NB, C>& S, int n,
                                             int i, const float x[NB]) {
  const float* cl = S.ci + i;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    float acc = cl[tri(r, 0) * n] * x[0];
#pragma unroll
    for (int j = 1; j <= r; ++j) acc = acc + cl[tri(r, j) * n] * x[j];
    S.D[i * NB + r] = acc;
  }
}

// D_i = Cinv_i^T D_i (knot i's thread).
template <int NB, bool C>
__device__ __forceinline__ void ci_t_mul_in_place(const SweepSmem<NB, C>& S,
                                                  int n, int i) {
  const float* cl = S.ci + i;
  float y[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) y[c] = S.D[i * NB + c];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float acc = cl[tri(c, c) * n] * y[c];
#pragma unroll
    for (int a = c + 1; a < NB; ++a) acc = acc + cl[tri(a, c) * n] * y[a];
    S.D[i * NB + c] = acc;
  }
}

// d - g . x, summed as two halves so the dependent chain is about NB / 2
// operations long instead of NB.
template <int NB>
__device__ __forceinline__ float sub_dot(float d, const float g[NB],
                                         const float x[NB]) {
  constexpr int h = NB / 2;
  float a = d - g[0] * x[0];
#pragma unroll
  for (int j = 1; j < h; ++j) a = a - g[j] * x[j];
  float c = g[h] * x[h];
#pragma unroll
  for (int j = h + 1; j < NB; ++j) c = c + g[j] * x[j];
  return a - c;
}

// One sweep over the n knots of a CTA in the direction `step` (+1 forward
// from knot 0 with M = G, -1 backward from knot n-1 with M = H):
// D_i = D_i - M_i D_prev, where lane r's x0 is row r of the D_prev before
// the first knot (0 at the scenario's ends, where M is 0).
// Called by lanes 0..NB-1 of one warp and no other thread.
// Each step's operands are loaded one step ahead, so that only the shuffles
// and the arithmetic lie on the dependent chain.
template <int NB>
__device__ __forceinline__ void sweep(const float* M, float* D, int n,
                                      int lane, bool forward, float x0) {
  constexpr unsigned mask = (1u << NB) - 1u;
  const int step = forward ? 1 : -1;
  int i = forward ? 0 : n - 1;
  float m[NB], d = D[i * NB + lane];
#pragma unroll
  for (int j = 0; j < NB; ++j) m[j] = M[(i * NB + lane) * NB + j];
  float x = x0;
  for (int s = 0; s < n; ++s) {
    const int cur = i;
    float mc[NB], xp[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) mc[j] = m[j];
    const float dc = d;
    if (s + 1 < n) {
      i += step;
      d = D[i * NB + lane];
#pragma unroll
      for (int j = 0; j < NB; ++j) m[j] = M[(i * NB + lane) * NB + j];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) xp[j] = __shfl_sync(mask, x, j);
    x = sub_dot<NB>(dc, mc, xp);
    D[cur * NB + lane] = x;
  }
}

// The steps of sweep() over one chunk of a cluster CTA's ring: len <=
// kChunkKnots knots from local knot i on, their rows at row0 +
// t row_step (t = 0 .. len-1), x the vector carried from step to step.
// Unrolled, so a full chunk (len == kChunkKnots) has no loop.
template <int NB>
__device__ __forceinline__ void walk_chunk(const float* row0, int row_step,
                                           float* D, int& i, int step,
                                           int lane, float& x, int len) {
  constexpr unsigned mask = (1u << NB) - 1u;
  float m[NB], d = D[i * NB + lane];
#pragma unroll
  for (int j = 0; j < NB; ++j) m[j] = row0[j];
#pragma unroll
  for (int t = 0; t < kChunkKnots; ++t) {
    if (t < len) {
      const int cur = i;
      float mc[NB], xp[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) mc[j] = m[j];
      const float dc = d;
      i += step;
      if (t + 1 < len) {
        d = D[i * NB + lane];
        const float* r = row0 + (t + 1) * row_step;
#pragma unroll
        for (int j = 0; j < NB; ++j) m[j] = r[j];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) xp[j] = __shfl_sync(mask, x, j);
      x = sub_dot<NB>(dc, mc, xp);
      D[cur * NB + lane] = x;
    }
  }
}

// sweep() in a cluster CTA: the same steps in the same order, with M_i
// read from device memory (M + i bs, the CTA's local knot i) through the
// ring. The walk takes its knots in chunks of kChunkKnots; lane 0 copies
// chunk q + kRingChunks - 1 into the slot chunk q - 1 left, once every
// lane has read that (__syncwarp), and each lane waits for chunk q's
// barrier before reading it. `phase` holds each slot barrier's parity
// across sweeps.
template <int NB>
__device__ __forceinline__ void sweep_streamed(const float* M, float* ring,
                                               uint64_t* bars,
                                               unsigned& phase, float* D,
                                               int n, int lane, bool forward,
                                               float x0) {
  constexpr unsigned mask = (1u << NB) - 1u;
  constexpr int C = kChunkKnots, P = kRingChunks, BS = block_stride(NB);
  const int step = forward ? 1 : -1;
  const int chunks = (n + C - 1) / C;
  auto fetch = [&](int q) {  // lane 0: chunk q into slot q % P
    if (q < chunks) {
      const int len = min(C, n - q * C);
      const int lo = forward ? q * C : n - q * C - len;
      bulk_load(ring + (q % P) * (C * BS), M + static_cast<size_t>(lo) * BS,
                static_cast<unsigned>(len * BS * sizeof(float)),
                bars + q % P);
    }
  };
  if (lane == 0)
    for (int q = 0; q < P - 1; ++q) fetch(q);
  float x = x0;
  int i = forward ? 0 : n - 1;
  for (int q = 0; q < chunks; ++q) {
    if (q > 0) __syncwarp(mask);
    if (lane == 0) fetch(q + P - 1);
    const int slot = q % P;
    barrier_wait(bars + slot, (phase >> slot) & 1u);
    phase ^= 1u << slot;
    // the chunk's blocks lie in memory order: walked up, or down from the
    // last
    const int len = min(C, n - q * C);
    const float* blk = ring + slot * (C * BS) + lane * NB;
    const float* row0 = forward ? blk : blk + (len - 1) * BS;
    const int row_step = forward ? BS : -BS;
    if (len == C)
      walk_chunk<NB>(row0, row_step, D, i, step, lane, x, C);
    else
      walk_chunk<NB>(row0, row_step, D, i, step, lane, x, len);
  }
}

// Both sweeps of one solve, D = d on entry and vt on return; every thread
// of every CTA of the scenario calls it (il: the thread's local knot). The
// barriers separate the CTAs' turns, the sweeps from the parallel step
// between them and from the callers' phases; without a cluster they are
// the CTA's three.
template <int NB, bool Cluster>
__device__ __forceinline__ void solve_in_place(
    const SweepSmem<NB, Cluster>& S, const Span<Cluster>& sp, int il,
    unsigned& phase) {
  const int lane = threadIdx.x;
  for (int r = 0; r < sp.size; ++r) {
    if (sp.rank == r && lane < NB) {
      if constexpr (Cluster) {
        const float x0 =
            r > 0 ? peer(S.D, r - 1)[(sp.k - 1) * NB + lane] : 0.f;
        sweep_streamed<NB>(S.G, S.ring, S.bars, phase, S.D, sp.count, lane,
                           true, x0);
      } else {
        sweep<NB>(S.G, S.D, sp.count, lane, true, 0.f);
      }
    }
    knot_sync<Cluster>();
  }
  if (il < sp.count) ci_t_mul_in_place<NB>(S, sp.k, il);
  __syncthreads();
  for (int r = sp.size - 1; r >= 0; --r) {
    if (sp.rank == r && lane < NB) {
      if constexpr (Cluster) {
        const float x0 = r + 1 < sp.size ? peer(S.D, r + 1)[lane] : 0.f;
        sweep_streamed<NB>(S.H, S.ring, S.bars, phase, S.D, sp.count, lane,
                           false, x0);
      } else {
        sweep<NB>(S.H, S.D, sp.count, lane, false, 0.f);
      }
    }
    knot_sync<Cluster>();
  }
}

// nanmax over the 32 lanes of a warp (every lane gets the result).
__device__ __forceinline__ float warp_nanmax(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace pathopt
