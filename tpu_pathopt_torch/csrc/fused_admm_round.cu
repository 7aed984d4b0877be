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
// A is the path QP's fixed structure: 3 transition rows per knot
// (-v_i[0:3] + Tprev_i v_{i-1}), 1 kappa row, the collision rows
// v0 + lf v1 + v4 and v0 + lr v1 + v5, and the 2 end rows v[end_idx][0:2].
// After the iterations it writes per scenario res = [pri, dua,
// max(|Av|, |z|), max(|Pv|, |A^T y|)] on the final iterate. The order of
// operations follows the TPU kernel (fused_rounds.py:253-288).
//
// What bounds it on the H100: every iteration is two sequential sweeps over
// N = 128 knots, each step a dependent 6x6 matvec on the previous step's
// result. The bytes it needs (the factors and the problem, about 20 MB at
// B = 256, read once per round) and its flops are small; the latency of the
// 2 x 128 dependent steps per iteration, on one thread per scenario, is what
// bounds it, and B = 256 scenarios fill only 8 SMs.
//
// What the design does about it: one thread per scenario runs all iterations
// of the round without leaving the kernel. The iterate lives in the output
// arrays and the sweep scratch in one (N, 6, B) buffer, batch-fastest, so
// each load is coalesced across the warp and the working set (under 20 MB)
// stays in the 50 MB L2 between iterations. Only the lower triangle of each
// Cinv block is read. The end rows are applied from an integer knot index
// instead of a one-hot selector.
#include "common.cuh"

namespace pathopt {
namespace {

constexpr int NB = 6;

struct PathArgs {
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
  float* v;           // (N, 6, B) iterate, in and out
  float* zk;
  float* ze;          // (2, B)
  float* yk;
  float* ye;
  float* res;         // (4, B)
  float* sweep;       // (N, 6, B) scratch
  int n, batch, iters;
  float alpha, one_minus_alpha, sigma, lf, lr;
};

struct Lane {
  PathArgs p;
  int b;
  __device__ size_t k6(int i, int r) const {
    return (static_cast<size_t>(i) * NB + r) * p.batch + b;
  }
  __device__ size_t m66(int i, int r, int c) const {
    return ((static_cast<size_t>(i) * NB + r) * NB + c) * p.batch + b;
  }
  __device__ size_t t36(int i, int r, int c) const {
    return ((static_cast<size_t>(i) * 3 + r) * NB + c) * p.batch + b;
  }
  __device__ size_t e2(int r) const {
    return static_cast<size_t>(r) * p.batch + b;
  }
};

// contrib[c] = sum_r tp[i][r][c] w[r] over the 3 transition rows of knot i:
// the A^T share that row group i sends to knot i-1.
__device__ __forceinline__ void trans_contrib(const Lane& L, int i,
                                              const float w[NB],
                                              float out[NB]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float acc = L.p.tp[L.t36(i, 0, c)] * w[0];
    acc = acc + L.p.tp[L.t36(i, 1, c)] * w[1];
    acc = acc + L.p.tp[L.t36(i, 2, c)] * w[2];
    out[c] = acc;
  }
}

// (A^T [w; we])_i given w of knots i and i+1 (wn unused when last).
__device__ __forceinline__ void at_mul_knot(const Lane& L, int i,
                                            const float w[NB],
                                            const float wn[NB], bool last,
                                            bool is_end, float we0, float we1,
                                            float out[NB]) {
  const float lf = L.p.lf, lr = L.p.lr;
  float o0 = -w[0] + w[4] + w[5];
  float o1 = -w[1] + lf * w[4] + lr * w[5];
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
  if (!last) {
    float contrib[NB];
    trans_contrib(L, i + 1, wn, contrib);
#pragma unroll
    for (int c = 0; c < NB; ++c) out[c] = out[c] + contrib[c];
  }
}

// Rows of A v at knot i given v_i and v_{i-1} (zero before knot 0).
__device__ __forceinline__ void a_mul_knot(const Lane& L, int i,
                                           const float v[NB],
                                           const float vp[NB],
                                           float z[NB]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float ctr = L.p.tp[L.t36(i, r, 0)] * vp[0];
#pragma unroll
    for (int j = 1; j < NB; ++j) ctr = ctr + L.p.tp[L.t36(i, r, j)] * vp[j];
    z[r] = -v[r] + ctr;
  }
  z[3] = v[2];
  z[4] = v[0] + L.p.lf * v[1] + v[4];
  z[5] = v[0] + L.p.lr * v[1] + v[5];
}

__global__ void __launch_bounds__(kScenarioThreads)
fused_admm_round_kernel(PathArgs p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const Lane L{p, b};
  const int n = p.n;
  // The end knot, clamped into [0, n) as the plain version's end_knot does.
  const int e = min(max(p.end_idx[b], 0), n - 1);
  const float re0 = p.re[L.e2(0)], re1 = p.re[L.e2(1)];
  const float lbe0 = p.lbe[L.e2(0)], lbe1 = p.lbe[L.e2(1)];
  const float ube0 = p.ube[L.e2(0)], ube1 = p.ube[L.e2(1)];
  float ze0 = p.ze[L.e2(0)], ze1 = p.ze[L.e2(1)];
  float ye0 = p.ye[L.e2(0)], ye1 = p.ye[L.e2(1)];
  const float alpha = p.alpha, oma = p.one_minus_alpha;

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma v + A^T (rho z - y), into the sweep buffer ----
    const float we0 = re0 * ze0 - ye0;
    const float we1 = re1 * ze1 - ye1;
    float w[NB], wn[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r)
      w[r] = p.rk[L.k6(0, r)] * p.zk[L.k6(0, r)] - p.yk[L.k6(0, r)];
    for (int i = 0; i < n; ++i) {
      const bool last = i == n - 1;
      if (!last) {
#pragma unroll
        for (int r = 0; r < NB; ++r)
          wn[r] = p.rk[L.k6(i + 1, r)] * p.zk[L.k6(i + 1, r)]
                  - p.yk[L.k6(i + 1, r)];
      }
      float out[NB];
      at_mul_knot(L, i, w, wn, last, i == e, we0, we1, out);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        p.sweep[L.k6(i, c)] = p.sigma * p.v[L.k6(i, c)] + out[c];
#pragma unroll
      for (int r = 0; r < NB; ++r) w[r] = wn[r];
    }

    // ---- forward sweep: y_i = Cinv_i (rhs_i - W_i y_{i-1}) ----
    float yp[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) yp[r] = 0.f;
    for (int i = 0; i < n; ++i) {
      float t[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float acc = p.Wp[L.m66(i, r, 0)] * yp[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) acc = acc + p.Wp[L.m66(i, r, j)] * yp[j];
        t[r] = p.sweep[L.k6(i, r)] - acc;
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float acc = p.Ci[L.m66(i, r, 0)] * t[0];
#pragma unroll
        for (int j = 1; j <= r; ++j) acc = acc + p.Ci[L.m66(i, r, j)] * t[j];
        yp[r] = acc;
        p.sweep[L.k6(i, r)] = acc;
      }
    }

    // ---- backward sweep: vt_i = Cinv_i^T (y_i - W_{i+1}^T vt_{i+1}) ----
    float vn[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) vn[r] = 0.f;
    for (int i = n - 1; i >= 0; --i) {
      float t[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = 0.f;
        if (i < n - 1) {
          acc = p.Wp[L.m66(i + 1, 0, c)] * vn[0];
#pragma unroll
          for (int a = 1; a < NB; ++a)
            acc = acc + p.Wp[L.m66(i + 1, a, c)] * vn[a];
        }
        t[c] = p.sweep[L.k6(i, c)] - acc;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = p.Ci[L.m66(i, c, c)] * t[c];
#pragma unroll
        for (int a = c + 1; a < NB; ++a) acc = acc + p.Ci[L.m66(i, a, c)] * t[a];
        vn[c] = acc;
        p.sweep[L.k6(i, c)] = acc;
      }
    }

    // ---- A vt, relaxed projection and dual update, knot by knot ----
    const float zte0 = p.sweep[L.k6(e, 0)];
    const float zte1 = p.sweep[L.k6(e, 1)];
    float vp[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) vp[r] = 0.f;
    for (int i = 0; i < n; ++i) {
      float vt[NB], zt[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) vt[c] = p.sweep[L.k6(i, c)];
      a_mul_knot(L, i, vt, vp, zt);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const size_t k = L.k6(i, c);
        p.v[k] = alpha * vt[c] + oma * p.v[k];
        const float rho = p.rk[k];
        const float ztmp = alpha * zt[c] + oma * p.zk[k] + p.yk[k] / rho;
        const float znew = clip(ztmp, p.lbk[k], p.ubk[k]);
        p.zk[k] = znew;
        p.yk[k] = rho * (ztmp - znew);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) vp[c] = vt[c];
    }
    const float ztmp0 = alpha * zte0 + oma * ze0 + ye0 / re0;
    const float ztmp1 = alpha * zte1 + oma * ze1 + ye1 / re1;
    const float zn0 = clip(ztmp0, lbe0, ube0);
    const float zn1 = clip(ztmp1, lbe1, ube1);
    ye0 = re0 * (ztmp0 - zn0);
    ye1 = re1 * (ztmp1 - zn1);
    ze0 = zn0;
    ze1 = zn1;
  }
  p.ze[L.e2(0)] = ze0;
  p.ze[L.e2(1)] = ze1;
  p.ye[L.e2(0)] = ye0;
  p.ye[L.e2(1)] = ye1;

  // ---- OSQP unscaled residuals of the final iterate ----
  float m_pri = 0.f, m_dua = 0.f, m_av = 0.f, m_z = 0.f, m_pv = 0.f,
        m_aty = 0.f;
  float vp[NB], w[NB], wn[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    vp[r] = 0.f;
    w[r] = p.yk[L.k6(0, r)];
  }
  for (int i = 0; i < n; ++i) {
    const bool last = i == n - 1;
    float v[NB], av[NB], aty[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) v[c] = p.v[L.k6(i, c)];
    a_mul_knot(L, i, v, vp, av);
    if (!last) {
#pragma unroll
      for (int r = 0; r < NB; ++r) wn[r] = p.yk[L.k6(i + 1, r)];
    }
    at_mul_knot(L, i, w, wn, last, i == e, ye0, ye1, aty);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const float z = p.zk[L.k6(i, c)];
      const float pv = p.pd[L.k6(i, c)] * v[c];
      m_pri = absmax(m_pri, av[c] - z);
      m_av = absmax(m_av, av[c]);
      m_z = absmax(m_z, z);
      m_dua = absmax(m_dua, pv + aty[c]);
      m_pv = absmax(m_pv, pv);
      m_aty = absmax(m_aty, aty[c]);
      vp[c] = v[c];
      w[c] = wn[c];
    }
  }
  const float ave0 = p.v[L.k6(e, 0)], ave1 = p.v[L.k6(e, 1)];
  const float pri_e = nanmax(fabsf(ave0 - ze0), fabsf(ave1 - ze1));
  const float av_e = nanmax(fabsf(ave0), fabsf(ave1));
  const float z_e = nanmax(fabsf(ze0), fabsf(ze1));
  p.res[L.e2(0)] = nanmax(m_pri, pri_e);
  p.res[L.e2(1)] = m_dua;
  p.res[L.e2(2)] = nanmax(nanmax(m_av, av_e), nanmax(m_z, z_e));
  p.res[L.e2(3)] = nanmax(m_pv, m_aty);
}

}  // namespace
}  // namespace pathopt

extern "C" int pathopt_fused_admm_round(
    const float* Ci, const float* Wp, const float* tp, const float* lbk,
    const float* ubk, const float* lbe, const float* ube, const float* rk,
    const float* re, const int* end_idx, const float* pd, float* v,
    float* zk, float* ze, float* yk, float* ye, float* res, float* sweep,
    int n, int batch, int iters, float alpha, float one_minus_alpha,
    float sigma, float lf, float lr, void* stream) {
  pathopt::PathArgs a{Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx, pd,
                      v, zk, ze, yk, ye, res, sweep, n, batch, iters, alpha,
                      one_minus_alpha, sigma, lf, lr};
  pathopt::fused_admm_round_kernel<<<pathopt::scenario_blocks(batch),
                                     pathopt::kScenarioThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(a);
  return pathopt::launch_status();
}
