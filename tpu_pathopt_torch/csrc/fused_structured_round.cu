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
  int n, batch, iters;
  float alpha, one_minus_alpha, sigma;
};

template <int NB, int R>
__global__ void __launch_bounds__(kMaxRoundThreads)
fused_structured_round_kernel(StructArgs p) {
  extern __shared__ float smem[];
  const int n = p.n, b = blockIdx.x, i = threadIdx.x;
  const bool own = i < n;
  const size_t B = p.batch;
  const SweepSmem<NB> S(smem, n);
  // knot i's a_cur and a_prev blocks, element (r, c) at [(r NB + c) n]
  const float* const ac_s = S.rest + i;
  const float* const ap_s = S.rest + R * NB * n + i;
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
    load_knot_factors<NB>(S, n, i, p.Ci + m0, i > 0 ? p.Wp + m0 : nullptr,
                          i < n - 1 ? p.Wp + m0 + NB * NB * B : nullptr, B);
    float* const a_s = S.rest + i;
#pragma unroll
    for (int k = 0; k < R * NB; ++k) {
      const size_t g = (static_cast<size_t>(i) * R * NB + k) * B + b;
      a_s[k * n] = p.ac[g];
      a_s[(R * NB + k) * n] = p.ap[g];
    }
  }
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma v - q + A^T (rho z - y), then d = Cinv rhs ----
    float w[R];
    if (own) {
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = rho[r] * z[r] - y[r];
      // a_prev[i]^T w_i goes to knot i-1
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float apw = ap_s[c * n] * w[0];
#pragma unroll
        for (int r = 1; r < R; ++r) apw = apw + ap_s[(r * NB + c) * n] * w[r];
        S.X[c * n + i] = apw;
      }
    }
    __syncthreads();
    if (own) {
      float rhs[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float atw = ac_s[c * n] * w[0];
#pragma unroll
        for (int r = 1; r < R; ++r) atw = atw + ac_s[(r * NB + c) * n] * w[r];
        if (i < n - 1) atw = atw + S.X[c * n + i + 1];
        rhs[c] = (sigma * v[c] - q[c]) + atw;
      }
      store_ci_mul<NB>(S, n, i, rhs);
    }
    __syncthreads();

    // ---- the two sweeps: D = vt ----
    solve_in_place<NB>(S, n, i);

    // ---- A vt, relaxed projection and dual update ----
    if (own) {
      float vt[NB], vp[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        vt[c] = S.D[i * NB + c];
        vp[c] = i > 0 ? S.D[(i - 1) * NB + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cur = ac_s[(r * NB) * n] * vt[0];
        float prv = ap_s[(r * NB) * n] * vp[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) {
          cur = cur + ac_s[(r * NB + j) * n] * vt[j];
          prv = prv + ap_s[(r * NB + j) * n] * vp[j];
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
}

template <int NB, int R>
int launch_structured(const StructArgs& a, int smem_bytes,
                      cudaStream_t stream) {
  const size_t need = round_smem_bytes(a.n, NB, 2 * R * NB, 0);
  if (const int err = round_config_error(a.n, a.batch, need, smem_bytes))
    return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_structured_round_kernel<NB, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fused_structured_round_kernel<NB, R>
      <<<a.batch, round_threads(a.n), smem_bytes, stream>>>(a);
  return launch_status();
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). An (nb, r) other
// than (4, 3), (3, 3) or (9, 9), a smem_bytes other than the CTA's shared
// memory for n knots (fused_rounds.round_smem_bytes), n above 256 or a
// batch of 0 returns cudaErrorInvalidValue without launching.
extern "C" int pathopt_fused_structured_round(
    const float* Ci, const float* Wp, const float* ac, const float* ap,
    const float* q, const float* lb, const float* ub, const float* rho,
    float* v, float* z, float* y, int n, int nb, int r, int batch, int iters,
    int smem_bytes, float alpha, float one_minus_alpha, float sigma,
    void* stream) {
  pathopt::StructArgs a{Ci, Wp, ac, ap, q, lb, ub, rho, v, z, y,
                        n, batch, iters, alpha, one_minus_alpha, sigma};
  auto s = static_cast<cudaStream_t>(stream);
  if (nb == 4 && r == 3)
    return pathopt::launch_structured<4, 3>(a, smem_bytes, s);
  if (nb == 3 && r == 3)
    return pathopt::launch_structured<3, 3>(a, smem_bytes, s);
  if (nb == 9 && r == 9)
    return pathopt::launch_structured<9, 9>(a, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
