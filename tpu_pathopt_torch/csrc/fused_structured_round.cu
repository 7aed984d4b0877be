// K3: one round of `iters` relaxed-ADMM iterations of a generic
// block-banded QP (TENSION2 smoothing: nb = 4, r = 3; post-smoothing:
// nb = 3, r = 3; TENSION smoothing: nb = 9, r = 9, points in triples).
//
// Replaces: tpu_pathopt/solver/fused_rounds.py, _structured_round_kernel
// (wrapper fused_structured_round, pallas_call at :396).
//
// Row group i of A is a_cur[i] v_i + a_prev[i] v_{i-1}. Each iteration:
//   rhs  = sigma v - q + A^T (rho z - y)
//   y_i  = Cinv_i (rhs_i - W_i y_{i-1}),  vt_i = Cinv_i^T (y_i - W_{i+1}^T vt_{i+1})
//   v    = alpha vt + (1 - alpha) v
//   zt   = alpha A vt + (1 - alpha) z + y / rho,  z = clip(zt, lb, ub),
//   y    = rho (zt - z)
// It returns (v, z, y); the caller computes the residuals. Arrays are
// batch-fastest: Ci/Wp (N, nb, nb, B), ac/ap (N, r, nb, B), q/v (N, nb, B),
// lb/ub/rho/z/y (N, r, B), float32. The sweeps run in the reassociated order
// of btri_sweep.cuh (one nb x nb matvec per step).
//
// What bounds it on the H100: as for K2, the two sweeps. Each step is one
// dependent nb x nb matvec: 2 x 64 x 25 = 3200 dependent steps per launch
// for TENSION2 (N = 64), 2 x 32 x 25 = 1600 for post-smoothing (N = 32) and
// 2 x 22 x 25 = 1100 for TENSION (N = 22), 40-80 ns a step. The bytes (a
// few MB at B = 256: 0.0017, 0.00065 and 0.0027 ms at 3.35 TB/s) and the
// flops are far below.
//
// What the design does about it: the design of K2. One CTA per scenario,
// one thread per knot, blockDim rounded up to a whole warp with the ragged
// threads masked (64 threads at N = 64, 32 at N = 32 and at N = 22), so
// B = 256 is one wave of 256 CTAs. The CTA copies Cinv (lower triangle),
// a_cur, a_prev and G_i = Cinv_i W_i, H_i = Cinv_i^T W_{i+1}^T into shared
// memory once: (2 nb^2 + 2 nb + nb (nb + 1) / 2 + 2 r nb) floats per knot,
// 18,944 bytes at (4, 3, N = 64), 6,144 at (3, 3, N = 32) and 34,056 at
// (9, 9, N = 22). Thread i keeps knot i's v, q, z, y, rho, lb and ub in
// registers for the whole launch; the rhs, A vt, the projection and the
// dual update run in parallel over knots, and only the sweeps are serial,
// on lanes 0..nb-1 of warp 0 (0..8 at nb 9; the shuffles name those lanes
// in their mask, so nb may be up to 32). Templated on (nb, r) so every
// block loop unrolls.
// Past what one CTA holds (256 knots; 150 at (9, 9), 232,200 bytes) a
// scenario takes a cluster of c CTAs, as in K2 (btri_sweep.cuh): at most 8,
// so 2048 knots at (4, 3) and (3, 3) and 1968 at (9, 9). Cluster barriers
// replace the CTA's around the neighbour exchanges, the edge knots read
// their neighbours from the next or previous CTA, and the sweeps pass from
// CTA to CTA, in the one-CTA order: the results are bit for bit the same
// at any c. As in K2, a cluster CTA streams G and H from a device-memory
// scratch buffer through a ring, and (4, 3) and (3, 3) are built for 80
// registers a thread, so that one wave holds the 256 scenarios of the long
// route's (4, 3) N 384 and (3, 3) N 300. (9, 9) keeps
// its registers (255; with fewer its state would spill more); the ring
// still lifts its limit from 150 knots a CTA to 246.
#include "btri_sweep.cuh"

namespace pathopt {
namespace {

struct StructArgs {
  const float* Ci;
  const float* Wp;
  const float* ac;
  const float* ap;
  const float* q;
  const float* lb;
  const float* ub;
  const float* rho;
  float* v;
  float* z;
  float* y;
  float* scratch;  // (2, B, N, bs) G and H of a cluster launch, else null
  int n, batch, iters;
  float alpha, one_minus_alpha, sigma;
  int knots;  // per CTA: the launch plan's k
};

// CTAs of 256 threads an SM holds that the cluster kernel at (NB, R) is
// built for: 3 at (4, 3) and (3, 3), 80 registers a thread (so 4 CTAs of
// the long route's 192 and 160 threads), and 1 at (9, 9).
template <int NB, int R>
constexpr int kClusterBlocks = NB * R <= 12 ? 3 : 1;

// The round: one CTA per scenario, or one CTA of a scenario's cluster.
template <int NB, int R, bool Cluster>
__device__ __forceinline__ void structured_round(StructArgs p) {
  extern __shared__ float smem[];
  const Span<Cluster> sp(p.n, p.knots);
  // i: the thread's knot, il: its place in this CTA, k: the CTA's stride
  const int n = p.n, k = sp.k, b = sp.b, il = threadIdx.x, i = sp.base + il;
  const bool own = il < sp.count;
  const size_t B = p.batch;
  const SweepSmem<NB, Cluster> S(smem, sp, n, p.batch, p.scratch);
  // knot i's a_cur and a_prev blocks, element (r, c) at [(r NB + c) k]
  const float* const ac_s = S.rest + il;
  const float* const ap_s = S.rest + R * NB * k + il;
  auto kv = [&](int c) { return (static_cast<size_t>(i) * NB + c) * B + b; };
  auto kr = [&](int r) { return (static_cast<size_t>(i) * R + r) * B + b; };
  const float alpha = p.alpha, oma = p.one_minus_alpha, sigma = p.sigma;

  // ---- load the scenario once ----
  float v[NB], q[NB], z[R], y[R], rho[R], lb[R], ub[R];
  if (own) {
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      v[c] = p.v[kv(c)];
      q[c] = p.q[kv(c)];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      z[r] = p.z[kr(r)];
      y[r] = p.y[kr(r)];
      rho[r] = p.rho[kr(r)];
      lb[r] = p.lb[kr(r)];
      ub[r] = p.ub[kr(r)];
    }
    const size_t m0 = static_cast<size_t>(i) * NB * NB * B + b;
    load_knot_factors<NB>(S, k, il, p.Ci + m0, i > 0 ? p.Wp + m0 : nullptr,
                          i < n - 1 ? p.Wp + m0 + NB * NB * B : nullptr, B);
    float* const a_s = S.rest + il;
#pragma unroll
    for (int e = 0; e < R * NB; ++e) {
      const size_t g = (static_cast<size_t>(i) * R * NB + e) * B + b;
      a_s[e * k] = p.ac[g];
      a_s[(R * NB + e) * k] = p.ap[g];
    }
  }
  ready_ring(S);
  knot_sync<Cluster>();
  unsigned ring_phase = 0;  // the ring barriers' parities (a cluster's)

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma v - q + A^T (rho z - y), then d = Cinv rhs ----
    float w[R];
    if (own) {
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = rho[r] * z[r] - y[r];
      // a_prev[i]^T w_i goes to knot i-1
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float apw = ap_s[c * k] * w[0];
#pragma unroll
        for (int r = 1; r < R; ++r) apw = apw + ap_s[(r * NB + c) * k] * w[r];
        S.X[c * k + il] = apw;
      }
    }
    knot_sync<Cluster>();
    if (own) {
      const float* xn = next_col(sp, S.X, il);
      float rhs[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float atw = ac_s[c * k] * w[0];
#pragma unroll
        for (int r = 1; r < R; ++r) atw = atw + ac_s[(r * NB + c) * k] * w[r];
        if (i < n - 1) atw = atw + xn[c * k];
        rhs[c] = (sigma * v[c] - q[c]) + atw;
      }
      store_ci_mul<NB>(S, k, il, rhs);
    }
    __syncthreads();

    // ---- the two sweeps: D = vt ----
    solve_in_place<NB>(S, sp, il, ring_phase);

    // ---- A vt, relaxed projection and dual update ----
    if (own) {
      float vt[NB], vp[NB];
      const float* dp = prev_row(sp, S.D, il, NB);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        vt[c] = S.D[il * NB + c];
        vp[c] = i > 0 ? dp[c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cur = ac_s[(r * NB) * k] * vt[0];
        float prv = ap_s[(r * NB) * k] * vp[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) {
          cur = cur + ac_s[(r * NB + j) * k] * vt[j];
          prv = prv + ap_s[(r * NB + j) * k] * vp[j];
        }
        const float ztmp = alpha * (cur + prv) + oma * z[r] + y[r] / rho[r];
        const float znew = clip(ztmp, lb[r], ub[r]);
        y[r] = rho[r] * (ztmp - znew);
        z[r] = znew;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) v[c] = alpha * vt[c] + oma * v[c];
    }
  }

  if (own) {
#pragma unroll
    for (int c = 0; c < NB; ++c) p.v[kv(c)] = v[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p.z[kr(r)] = z[r];
      p.y[kr(r)] = y[r];
    }
  }
  // No CTA leaves while a neighbour may still read its last vt.
  if constexpr (Cluster) knot_sync<Cluster>();
}

template <int NB, int R>
__global__ void __launch_bounds__(kMaxRoundThreads)
fused_structured_round_kernel(StructArgs p) {
  structured_round<NB, R, false>(p);
}

template <int NB, int R>
__global__ void __launch_bounds__(kMaxRoundThreads, kClusterBlocks<NB, R>)
fused_structured_round_cluster_kernel(StructArgs p) {
  structured_round<NB, R, true>(p);
}

template <int NB, int R>
int launch_structured(const StructArgs& a, int smem_bytes, int cluster,
                      int forced, cudaStream_t stream) {
  const RoundPlan plan = round_plan(a.n, NB, 2 * R * NB, 0, forced);
  if (const int err = round_config_error(plan, a.batch, cluster, a.knots,
                                        smem_bytes, a.scratch))
    return err;
  return launch_round(fused_structured_round_kernel<NB, R>,
                      fused_structured_round_cluster_kernel<NB, R>, plan,
                      a.batch, a, stream);
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). An (nb, r) other
// than (4, 3), (3, 3) or (9, 9), a (cluster, knots, smem_bytes) other than
// the launch plan for n knots (round_plan, or with `forced` > 0 the plan at
// exactly that cluster size; fused_rounds.round_plan in Python computes the
// same), a shape no plan takes, a batch of 0 or a cluster plan without
// `scratch` (2 B n bs floats, bs = nb^2 rounded up to a multiple of 4;
// device memory the launch may overwrite)
// returns cudaErrorInvalidValue without launching.
extern "C" int pathopt_fused_structured_round(
    const float* Ci, const float* Wp, const float* ac, const float* ap,
    const float* q, const float* lb, const float* ub, const float* rho,
    float* v, float* z, float* y, float* scratch, int n, int nb, int r,
    int batch, int iters, int cluster, int knots, int forced, int smem_bytes,
    float alpha, float one_minus_alpha, float sigma, void* stream) {
  pathopt::StructArgs a{Ci, Wp, ac, ap, q, lb, ub, rho, v, z, y, scratch,
                        n, batch, iters, alpha, one_minus_alpha, sigma,
                        knots};
  auto s = static_cast<cudaStream_t>(stream);
  if (nb == 4 && r == 3)
    return pathopt::launch_structured<4, 3>(a, smem_bytes, cluster,
                                            forced, s);
  if (nb == 3 && r == 3)
    return pathopt::launch_structured<3, 3>(a, smem_bytes, cluster,
                                            forced, s);
  if (nb == 9 && r == 9)
    return pathopt::launch_structured<9, 9>(a, smem_bytes, cluster,
                                            forced, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
