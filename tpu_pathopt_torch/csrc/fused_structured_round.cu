// K3: one round of `iters` relaxed-ADMM iterations of a generic
// block-banded QP (TENSION2 smoothing: nb = 4, r = 3; post-smoothing:
// nb = 3, r = 3).
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
// lb/ub/rho/z/y (N, r, B), float32.
//
// What bounds it on the H100: as for K2, two sequential knot sweeps per
// iteration, each step a dependent nb x nb matvec. At N = 64 / 32 and
// B = 256 the problem is a few MB; the dependent-step latency on one thread
// per scenario bounds it, and the batch fills only B/32 SMs.
//
// What the design does about it: one thread per scenario runs the whole
// round in one launch, templated on (nb, r) so every block loop unrolls into
// registers; the iterate is updated in place in the output arrays and the
// sweep uses one (N, nb, B) scratch buffer, all coalesced across the warp
// and L2-resident between iterations.
#include "common.cuh"

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
  float* sweep;
  int n, batch, iters;
  float alpha, one_minus_alpha, sigma;
};

template <int NB, int R>
struct SLane {
  StructArgs p;
  int b;
  __device__ size_t kv(int i, int c) const {
    return (static_cast<size_t>(i) * NB + c) * p.batch + b;
  }
  __device__ size_t kr(int i, int r) const {
    return (static_cast<size_t>(i) * R + r) * p.batch + b;
  }
  __device__ size_t mm(int i, int r, int c) const {
    return ((static_cast<size_t>(i) * NB + r) * NB + c) * p.batch + b;
  }
  __device__ size_t ma(int i, int r, int c) const {
    return ((static_cast<size_t>(i) * R + r) * NB + c) * p.batch + b;
  }
};

template <int NB, int R>
__global__ void __launch_bounds__(kScenarioThreads)
fused_structured_round_kernel(StructArgs p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const SLane<NB, R> L{p, b};
  const int n = p.n;
  const float alpha = p.alpha, oma = p.one_minus_alpha;

  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs = sigma v - q + A^T (rho z - y), into the sweep buffer ----
    float w[R], wn[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      w[r] = p.rho[L.kr(0, r)] * p.z[L.kr(0, r)] - p.y[L.kr(0, r)];
    for (int i = 0; i < n; ++i) {
      const bool last = i == n - 1;
      if (!last) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          wn[r] = p.rho[L.kr(i + 1, r)] * p.z[L.kr(i + 1, r)]
                  - p.y[L.kr(i + 1, r)];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float atw = p.ac[L.ma(i, 0, c)] * w[0];
#pragma unroll
        for (int r = 1; r < R; ++r) atw = atw + p.ac[L.ma(i, r, c)] * w[r];
        if (!last) {
          float apw = p.ap[L.ma(i + 1, 0, c)] * wn[0];
#pragma unroll
          for (int r = 1; r < R; ++r)
            apw = apw + p.ap[L.ma(i + 1, r, c)] * wn[r];
          atw = atw + apw;
        }
        const size_t k = L.kv(i, c);
        p.sweep[k] = (p.sigma * p.v[k] - p.q[k]) + atw;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = wn[r];
    }

    // ---- forward sweep ----
    float yp[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) yp[c] = 0.f;
    for (int i = 0; i < n; ++i) {
      float t[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float acc = p.Wp[L.mm(i, r, 0)] * yp[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) acc = acc + p.Wp[L.mm(i, r, j)] * yp[j];
        t[r] = p.sweep[L.kv(i, r)] - acc;
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float acc = p.Ci[L.mm(i, r, 0)] * t[0];
#pragma unroll
        for (int j = 1; j <= r; ++j) acc = acc + p.Ci[L.mm(i, r, j)] * t[j];
        yp[r] = acc;
        p.sweep[L.kv(i, r)] = acc;
      }
    }

    // ---- backward sweep ----
    float vn[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) vn[c] = 0.f;
    for (int i = n - 1; i >= 0; --i) {
      float t[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = 0.f;
        if (i < n - 1) {
          acc = p.Wp[L.mm(i + 1, 0, c)] * vn[0];
#pragma unroll
          for (int a = 1; a < NB; ++a)
            acc = acc + p.Wp[L.mm(i + 1, a, c)] * vn[a];
        }
        t[c] = p.sweep[L.kv(i, c)] - acc;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = p.Ci[L.mm(i, c, c)] * t[c];
#pragma unroll
        for (int a = c + 1; a < NB; ++a) acc = acc + p.Ci[L.mm(i, a, c)] * t[a];
        vn[c] = acc;
        p.sweep[L.kv(i, c)] = acc;
      }
    }

    // ---- A vt, relaxed projection and dual update ----
    float vp[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) vp[c] = 0.f;
    for (int i = 0; i < n; ++i) {
      float vt[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) vt[c] = p.sweep[L.kv(i, c)];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cur = p.ac[L.ma(i, r, 0)] * vt[0];
        float prv = p.ap[L.ma(i, r, 0)] * vp[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) {
          cur = cur + p.ac[L.ma(i, r, j)] * vt[j];
          prv = prv + p.ap[L.ma(i, r, j)] * vp[j];
        }
        const float zt = cur + prv;
        const size_t k = L.kr(i, r);
        const float rho = p.rho[k];
        const float ztmp = alpha * zt + oma * p.z[k] + p.y[k] / rho;
        const float znew = clip(ztmp, p.lb[k], p.ub[k]);
        p.z[k] = znew;
        p.y[k] = rho * (ztmp - znew);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const size_t k = L.kv(i, c);
        p.v[k] = alpha * vt[c] + oma * p.v[k];
        vp[c] = vt[c];
      }
    }
  }
}

template <int NB, int R>
int launch_structured(const StructArgs& a, cudaStream_t stream) {
  fused_structured_round_kernel<NB, R>
      <<<scenario_blocks(a.batch), kScenarioThreads, 0, stream>>>(a);
  return launch_status();
}

}  // namespace
}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success); an (nb, r) other
// than (4, 3) or (3, 3) returns cudaErrorInvalidValue without launching.
extern "C" int pathopt_fused_structured_round(
    const float* Ci, const float* Wp, const float* ac, const float* ap,
    const float* q, const float* lb, const float* ub, const float* rho,
    float* v, float* z, float* y, float* sweep, int n, int nb, int r,
    int batch, int iters, float alpha, float one_minus_alpha, float sigma,
    void* stream) {
  pathopt::StructArgs a{Ci, Wp, ac, ap, q, lb, ub, rho, v, z, y, sweep,
                        n, batch, iters, alpha, one_minus_alpha, sigma};
  auto s = static_cast<cudaStream_t>(stream);
  if (nb == 4 && r == 3) return pathopt::launch_structured<4, 3>(a, s);
  if (nb == 3 && r == 3) return pathopt::launch_structured<3, 3>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
