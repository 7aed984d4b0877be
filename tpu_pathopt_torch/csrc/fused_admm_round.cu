// K2: one round of `iters` relaxed-ADMM iterations of the lateral path QP,
// plus the OSQP residuals of the final iterate.
//
// Replaces: tpu_pathopt/solver/fused_rounds.py, _round_kernel (wrapper
// fused_admm_round, pallas_call at :453).
//
// Each iteration, per scenario (nb = 6 variables and 6 rows per knot, 2 end
// rows at knot end_idx):
//   rhs  = sigma v + A^T (rho z - y)
//   y_i  = Cinv_i (rhs_i - W_i y_{i-1})              forward sweep
//   vt_i = Cinv_i^T (y_i - W_{i+1}^T vt_{i+1})        backward sweep
//   v    = alpha vt + (1 - alpha) v
//   zt   = alpha A vt + (1 - alpha) z + y / rho,  z = clip(zt, lb, ub),
//   y    = rho (zt - z)
// A is the path QP's structure: 3 transition rows per knot
// (-v_i[0:3] + Tprev_i v_{i-1}), 1 kappa row, the two collision rows
// f0 v0 + f1 v1 + v4 and r0 v0 + r1 v1 + v5 with each knot's own
// coefficients (cc, 4 floats a knot: (1, lf) and (1, lr) at the default
// config, (1, 0) and (0, 0) on the rough far-away knots), and the 2 end
// rows v[end_idx][0:2]. The Pallas kernel takes one (lf, lr) for the whole
// batch and so iterates another operator than the one factored wherever
// the rows differ by knot.
// After the iterations it writes per scenario res = [pri, dua,
// max(|Av|, |z|), max(|Pv|, |A^T y|)] on the final iterate. The sweeps run
// in the reassociated order of btri_sweep.cuh (G_i = Cinv_i W_i, one matvec
// per step); everything else follows the TPU kernel (fused_rounds.py:253-288).
//
// What bounds it on the H100: the two sweeps, the only sequential part.
// Each step is one dependent 6 x 6 matvec on the previous step's result:
// 2 sweeps x 128 knots x 25 iterations = 6400 dependent steps per launch
// (25,600 at the long route's 512 knots). At about 40-80 ns a step (a
// round of shuffles, then a chain of 4 dependent float operations, every
// operand in shared memory) that is 0.25-0.5 ms at 128 knots. The bytes
// (the factors and the problem, about 20 MB at B = 256, read once:
// 0.006 ms at 3.35 TB/s) and the flops are far below it.
//
// What the design does about it: one CTA per scenario, one thread per knot
// (128 threads at N = 128), so B = 256 scenarios are 256 CTAs, resident in
// one wave at 2 per SM on 132 SMs (264 slots). The CTA copies its scenario's
// Cinv (lower triangle), the transition blocks and the precomputed
// G_i = Cinv_i W_i, H_i = Cinv_i^T W_{i+1}^T into shared memory once:
// (2 x 36 + 2 x 6 + 21 + 18) floats x 128 knots + 48 = 63,168 bytes, so two
// CTAs take 124 KB of the SM's 228 KB. Thread i keeps knot i's v, z, y,
// rho, lb, ub and collision coefficients in registers for the whole
// launch (only its own knot's rows use them, so no shared memory). The
// rhs, A vt, the projection, the dual update and the residuals run in
// parallel over knots, exchanging neighbour vectors through shared memory
// between barriers; the residuals end in a warp-shuffle and shared-memory
// max reduction that propagates NaN as jnp.max does. Only the sweeps are serial, on lanes 0-5
// of warp 0, one row per lane. Nothing is written to device memory before
// the last iteration ends.
// Past 256 knots a scenario takes a cluster of c CTAs (btri_sweep.cuh; c = 2
// at 512 knots, c = 4 at 1024; at most 8 CTAs, 2048 knots): the barriers
// around the neighbour exchanges become cluster barriers, the edge knots'
// neighbours are read from the next or previous CTA's shared memory, the
// sweeps pass from CTA to CTA, and the residual maxima of the CTAs are
// combined by rank 0. The arithmetic is the one-CTA kernel's, in the same
// order, so the results are bit for bit the same at any c.
// A cluster launch is bound by how many scenarios' walks the card holds at
// once, not by bytes: with the one-CTA layout (126,144 bytes at 256 knots)
// one CTA fits an SM, and 256 scenarios of 512 knots run in 4 waves of 66,
// each as long as one scenario's 25,600 steps. So the cluster CTAs keep G
// and H in a device-memory scratch buffer and stream them to the walk
// through a ring of bulk copies (btri_sweep.cuh): 51 floats a knot of
// shared memory instead of 123 (57,040 bytes at 256 knots), and 64
// registers a thread, so 4 CTAs of 256 threads share an SM and 512 knots x
// 256 scenarios fit in one wave.
#include "btri_sweep.cuh"

namespace pathopt {
namespace {

constexpr int NB = 6;
// Shared memory beyond the sweep's: the transition blocks (3 x 6 per knot)
// and the residual reduction's 6 maxima per warp.
constexpr int kTpFloats = 3 * NB;
constexpr int kResidualFloats = 6 * kMaxRoundWarps;
// CTAs of 256 threads an SM holds that the cluster kernel is built for: 64
// registers a thread, so that 4 CTAs of 57,040 bytes share an SM.
constexpr int kClusterMinBlocks = 4;

struct PathArgs {
  const float* cc;    // (N, 2, 2, B) collision rows: [row][v0, v1]
  const float* Ci;    // (N, 6, 6, B)
  const float* Wp;    // (N, 6, 6, B), Wp[0] = 0
  const float* tp;    // (N, 3, 6, B) transition blocks on knot i-1
  const float* lbk;   // (N, 6, B)
  const float* ubk;
  const float* lbe;   // (2, B)
  const float* ube;
  const float* rk;    // (N, 6, B) per-row rho
  const float* re;    // (2, B)
  const int* end_idx; // (B,)
  const float* pd;    // (N, 6, B) diagonal of P
  float* v;           // (N, 6, B) outputs
  float* zk;
  float* ze;          // (2, B)
  float* yk;
  float* ye;
  float* res;         // (4, B)
  float* scratch;     // (2, B, N, 6, 6) G and H of a cluster launch, else null
  int n, batch, iters;
  float alpha, one_minus_alpha, sigma;
  int knots;          // per CTA: the launch plan's k
};

// Knot i's collision rows: f0 v0 + f1 v1 + v4 and r0 v0 + r1 v1 + v5.
struct CollRows {
  float f0, f1, r0, r1;
};

// (A^T [w; we])_i without the share of knot i+1's transition rows.
__device__ __forceinline__ void at_mul_own(const float w[NB],
                                           const CollRows& c, bool is_end,
                                           float we0, float we1,
                                           float out[NB]) {
  float o0 = -w[0] + c.f0 * w[4] + c.r0 * w[5];
  float o1 = -w[1] + c.f1 * w[4] + c.r1 * w[5];
  if (is_end) {
    o0 = o0 + we0;
    o1 = o1 + we1;
  }
  out[0] = o0;
  out[1] = o1;
  out[2] = -w[2] + w[3];
  out[3] = 0.f;
  out[4] = w[4];
  out[5] = w[5];
}

// X[:, i] = sum_r tp_i[r][:] w[r]: the A^T share that knot i's transition
// rows send to knot i-1 (k: the stride of tp and X, i: the local knot).
__device__ __forceinline__ void store_trans_contrib(const float* tp, float* X,
                                                   int k, int i,
                                                   const float w[NB]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float acc = tp[c * k] * w[0];
    acc = acc + tp[(NB + c) * k] * w[1];
    acc = acc + tp[(2 * NB + c) * k] * w[2];
    X[c * k + i] = acc;
  }
}

// Rows of A v at knot i given v_i and v_{i-1} (zero before knot 0).
__device__ __forceinline__ void a_mul_knot(const float* tp, int k,
                                           const CollRows& c,
                                           const float v[NB],
                                           const float vp[NB], float z[NB]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float ctr = tp[(r * NB) * k] * vp[0];
#pragma unroll
    for (int j = 1; j < NB; ++j) ctr = ctr + tp[(r * NB + j) * k] * vp[j];
    z[r] = -v[r] + ctr;
  }
  z[3] = v[2];
  z[4] = c.f0 * v[0] + c.f1 * v[1] + v[4];
  z[5] = c.r0 * v[0] + c.r1 * v[1] + v[5];
}

// The round: one CTA per scenario, or one CTA of a scenario's cluster.
template <bool Cluster>
__device__ __forceinline__ void admm_round(PathArgs p) {
  extern __shared__ float smem[];
  const Span<Cluster> sp(p.n, p.knots);
  // i: the thread's knot, il: its place in this CTA, k: the CTA's stride
  const int n = p.n, k = sp.k, b = sp.b, il = threadIdx.x, i = sp.base + il;
  const bool own = il < sp.count;
  const size_t B = p.batch;
  const SweepSmem<NB, Cluster> S(smem, sp, n, p.batch, p.scratch);
  float* const tp_s = S.rest + il;  // knot i's (3, 6) block, stride k
  float* const red = S.rest + kTpFloats * k;
  auto k6 = [&](int j, int r) { return (static_cast<size_t>(j) * NB + r) * B + b; };
  auto e2 = [&](int r) { return static_cast<size_t>(r) * B + b; };

  // The end knot, clamped into [0, n) as the plain version's end_knot does.
  // Only its thread uses the end rows.
  const int e = min(max(p.end_idx[b], 0), n - 1);
  const bool is_end = Cluster ? own && i == e : i == e;
  const float re0 = p.re[e2(0)], re1 = p.re[e2(1)];
  const float lbe0 = p.lbe[e2(0)], lbe1 = p.lbe[e2(1)];
  const float ube0 = p.ube[e2(0)], ube1 = p.ube[e2(1)];
  float ze0 = p.ze[e2(0)], ze1 = p.ze[e2(1)];
  float ye0 = p.ye[e2(0)], ye1 = p.ye[e2(1)];
  const float alpha = p.alpha, oma = p.one_minus_alpha, sigma = p.sigma;
  CollRows cr{0.f, 0.f, 0.f, 0.f};
  if (own) {
    const size_t c0 = static_cast<size_t>(i) * 4 * B + b;
    cr = CollRows{p.cc[c0], p.cc[c0 + B], p.cc[c0 + 2 * B], p.cc[c0 + 3 * B]};
  }

  // ---- load the scenario once: the blocks, then knot i's vectors ----
  if (own) {
    const size_t m0 = static_cast<size_t>(i) * NB * NB * B + b;
    load_knot_factors<NB>(S, k, il, p.Ci + m0, i > 0 ? p.Wp + m0 : nullptr,
                          i < n - 1 ? p.Wp + m0 + NB * NB * B : nullptr, B);
#pragma unroll
    for (int q = 0; q < kTpFloats; ++q)
      tp_s[q * k] = p.tp[(static_cast<size_t>(i) * kTpFloats + q) * B + b];
  }
  float v[NB], zk[NB], yk[NB], rk[NB], lbk[NB], ubk[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const size_t q = own ? k6(i, r) : 0;
    v[r] = p.v[q];
    zk[r] = p.zk[q];
    yk[r] = p.yk[q];
    rk[r] = p.rk[q];
    lbk[r] = p.lbk[q];
    ubk[r] = p.ubk[q];
  }
  ready_ring(S);
  knot_sync<Cluster>();
  unsigned ring_phase = 0;  // the ring barriers' parities (a cluster's)

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma v + A^T (rho z - y), then d = Cinv rhs ----
    float w[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) w[r] = rk[r] * zk[r] - yk[r];
    if (own) store_trans_contrib(tp_s, S.X, k, il, w);
    knot_sync<Cluster>();
    if (own) {
      float rhs[NB];
      at_mul_own(w, cr, is_end, re0 * ze0 - ye0, re1 * ze1 - ye1, rhs);
      if (i < n - 1) {
        const float* xn = next_col(sp, S.X, il);
#pragma unroll
        for (int c = 0; c < NB; ++c) rhs[c] = rhs[c] + xn[c * k];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) rhs[c] = sigma * v[c] + rhs[c];
      store_ci_mul<NB>(S, k, il, rhs);
    }
    __syncthreads();

    // ---- the two sweeps: D = vt ----
    solve_in_place<NB>(S, sp, il, ring_phase);

    // ---- A vt, relaxed projection and dual update, knot by knot ----
    if (own) {
      float vt[NB], vp[NB], zt[NB];
      const float* dp = prev_row(sp, S.D, il, NB);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        vt[c] = S.D[il * NB + c];
        vp[c] = i > 0 ? dp[c] : 0.f;
      }
      a_mul_knot(tp_s, k, cr, vt, vp, zt);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        v[c] = alpha * vt[c] + oma * v[c];
        const float ztmp = alpha * zt[c] + oma * zk[c] + yk[c] / rk[c];
        const float znew = clip(ztmp, lbk[c], ubk[c]);
        zk[c] = znew;
        yk[c] = rk[c] * (ztmp - znew);
      }
      if (is_end) {
        const float ztmp0 = alpha * vt[0] + oma * ze0 + ye0 / re0;
        const float ztmp1 = alpha * vt[1] + oma * ze1 + ye1 / re1;
        const float zn0 = clip(ztmp0, lbe0, ube0);
        const float zn1 = clip(ztmp1, lbe1, ube1);
        ye0 = re0 * (ztmp0 - zn0);
        ye1 = re1 * (ztmp1 - zn1);
        ze0 = zn0;
        ze1 = zn1;
      }
    }
  }

  // ---- OSQP unscaled residuals of the final iterate ----
  // Knot i needs v_{i-1} and knot i+1's transition share of A^T y.
  knot_sync<Cluster>();
  if (own) {
#pragma unroll
    for (int c = 0; c < NB; ++c) S.D[il * NB + c] = v[c];
    store_trans_contrib(tp_s, S.X, k, il, yk);
  }
  knot_sync<Cluster>();
  // pri, dua, |Av|, |z|, |Pv|, |A^T y|
  float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (own) {
    float vp[NB], av[NB], aty[NB];
    const float* dp = prev_row(sp, S.D, il, NB);
#pragma unroll
    for (int c = 0; c < NB; ++c) vp[c] = i > 0 ? dp[c] : 0.f;
    a_mul_knot(tp_s, k, cr, v, vp, av);
    at_mul_own(yk, cr, is_end, ye0, ye1, aty);
    if (i < n - 1) {
      const float* xn = next_col(sp, S.X, il);
#pragma unroll
      for (int c = 0; c < NB; ++c) aty[c] = aty[c] + xn[c * k];
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const float pv = p.pd[k6(i, c)] * v[c];
      m[0] = absmax(m[0], av[c] - zk[c]);
      m[1] = absmax(m[1], pv + aty[c]);
      m[2] = absmax(m[2], av[c]);
      m[3] = absmax(m[3], zk[c]);
      m[4] = absmax(m[4], pv);
      m[5] = absmax(m[5], aty[c]);
    }
    if (is_end) {  // the end rows: A v there is v_e[0:2]
      m[0] = absmax(absmax(m[0], v[0] - ze0), v[1] - ze1);
      m[2] = absmax(absmax(m[2], v[0]), v[1]);
      m[3] = absmax(absmax(m[3], ze0), ze1);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      p.v[k6(i, c)] = v[c];
      p.zk[k6(i, c)] = zk[c];
      p.yk[k6(i, c)] = yk[c];
    }
    if (is_end) {
      p.ze[e2(0)] = ze0;
      p.ze[e2(1)] = ze1;
      p.ye[e2(0)] = ye0;
      p.ye[e2(1)] = ye1;
    }
  }
  const int warp = il >> 5, lane = il & 31;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    m[q] = warp_nanmax(m[q]);
    if (lane == 0) red[q * kMaxRoundWarps + warp] = m[q];
  }
  __syncthreads();
  if (il == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int q = 0; q < 6; ++q)
      for (int w = 1; w < warps; ++w)
        m[q] = nanmax(m[q], red[q * kMaxRoundWarps + w]);
    if constexpr (!Cluster) {
      p.res[e2(0)] = m[0];
      p.res[e2(1)] = m[1];
      p.res[e2(2)] = nanmax(m[2], m[3]);
      p.res[e2(3)] = nanmax(m[4], m[5]);
    }
  }
  if constexpr (Cluster) {
    // The CTAs' maxima, combined in rank order by rank 0; the last barrier
    // keeps every CTA's shared memory alive until rank 0 has read it.
    if (il == 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) red[q * kMaxRoundWarps] = m[q];
    }
    knot_sync<Cluster>();
    if (il == 0 && sp.rank == 0) {
      for (int r = 1; r < sp.size; ++r) {
        const float* pr = peer(red, r);
#pragma unroll
        for (int q = 0; q < 6; ++q)
          m[q] = nanmax(m[q], pr[q * kMaxRoundWarps]);
      }
      p.res[e2(0)] = m[0];
      p.res[e2(1)] = m[1];
      p.res[e2(2)] = nanmax(m[2], m[3]);
      p.res[e2(3)] = nanmax(m[4], m[5]);
    }
    knot_sync<Cluster>();
  }
}

__global__ void __launch_bounds__(kMaxRoundThreads)
fused_admm_round_kernel(PathArgs p) {
  admm_round<false>(p);
}

__global__ void __launch_bounds__(kMaxRoundThreads, kClusterMinBlocks)
fused_admm_round_cluster_kernel(PathArgs p) {
  admm_round<true>(p);
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). (cluster, knots,
// smem_bytes) must be the launch plan for n knots (round_plan, or with
// `forced` > 0 the plan at exactly that cluster size; fused_rounds.round_plan
// in Python computes the same): any other plan, a shape no plan takes, a
// batch of 0 or a cluster plan without `scratch` (2 B n 36 floats, device
// memory the launch may overwrite) returns cudaErrorInvalidValue without
// launching.
extern "C" int pathopt_fused_admm_round(
    const float* cc, const float* Ci, const float* Wp, const float* tp,
    const float* lbk, const float* ubk, const float* lbe, const float* ube,
    const float* rk, const float* re, const int* end_idx, const float* pd,
    float* v, float* zk, float* ze, float* yk, float* ye, float* res,
    float* scratch, int n, int batch, int iters, int cluster, int knots,
    int forced, int smem_bytes,
    float alpha, float one_minus_alpha, float sigma, void* stream) {
  using namespace pathopt;
  const RoundPlan plan =
      round_plan(n, NB, kTpFloats, kResidualFloats, forced);
  if (const int err = round_config_error(plan, batch, cluster, knots,
                                        smem_bytes, scratch))
    return err;
  PathArgs a{cc, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx, pd,
             v, zk, ze, yk, ye, res, scratch, n, batch, iters, alpha,
             one_minus_alpha, sigma, knots};
  return launch_round(fused_admm_round_kernel,
                      fused_admm_round_cluster_kernel, plan, batch, a,
                      static_cast<cudaStream_t>(stream));
}
