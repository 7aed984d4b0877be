// K1: batched block-tridiagonal Cholesky factorization with explicit block
// inverse.
//
// Replaces: tpu_pathopt/solver/fused_rounds.py, _factor_kernel (wrapper
// fused_factor, pallas_call at :179).
//
// Per knot i, in order:
//   W_i    = Off_{i-1} Cinv_{i-1}^T          (Off_{-1} = 0, so W_0 = 0)
//   S_i    = D_i - W_i W_i^T
//   C_i    = chol(S_i), pivot sqrt(max(d, 1e-12))
//   Cinv_i = C_i^{-1}
// Inputs diag, offp and outputs cinv, w are (N, nb, nb, B) float32 with the
// batch fastest; offp[0] = 0.
//
// What bounds it on the H100: the knot recurrence is sequential, so each
// scenario is one dependent chain of N small dense steps (about nb^3 flops
// each). At the path QP's shape (N = 128, nb = 6, B = 256) it reads and
// writes about 19 MB and does about 30 MFLOP, far below either roof; what
// bounds it is the latency of one thread walking 128 knots, and the batch
// fills only B/32 SMs.
//
// What the design does about it: one thread per scenario keeps the whole
// block recurrence in registers (nb x nb blocks, templated on nb so every
// loop unrolls) and touches device memory only to read D_i, Off_i and write
// Cinv_i, W_i, each exactly once, coalesced across the warp. Filling more
// SMs (several threads per scenario, or more scenarios per launch) is left
// for a later change.
#include "common.cuh"

namespace pathopt {

template <int NB>
__global__ void __launch_bounds__(kScenarioThreads)
fused_factor_kernel(const float* __restrict__ diag,
                    const float* __restrict__ offp,
                    float* __restrict__ cinv, float* __restrict__ wout,
                    int n, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t knot = static_cast<size_t>(NB) * NB * batch;
  auto at = [batch, b](int r, int c) {
    return static_cast<size_t>(r * NB + c) * batch + b;
  };

  float cp[NB][NB];  // Cinv of the previous knot, then of this knot
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int c = 0; c < NB; ++c) cp[r][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    const float* O = offp + i * knot;
    const float* D = diag + i * knot;
    float o[NB][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) o[r][c] = O[at(r, c)];

    // W = O Cinv_prev^T : W[r][c] = sum_j O[r][j] Cp[c][j]
    float W[NB][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = o[r][0] * cp[c][0];
#pragma unroll
        for (int j = 1; j < NB; ++j) acc = acc + o[r][j] * cp[c][j];
        W[r][c] = acc;
      }
    float* Wo = wout + i * knot;
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) Wo[at(r, c)] = W[r][c];

    // S = D - W W^T (lower triangle).
    float S[NB][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c <= r; ++c) {
        float acc = W[r][0] * W[c][0];
#pragma unroll
        for (int j = 1; j < NB; ++j) acc = acc + W[r][j] * W[c][j];
        S[r][c] = D[at(r, c)] - acc;
      }

    // Cholesky-Crout with the pivot floor of the TPU kernel.
    float C[NB][NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float d = S[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) d = d - C[j][k] * C[j][k];
      const float cjj = sqrtf(d != d ? d : fmaxf(d, 1e-12f));
      C[j][j] = cjj;
      const float inv = 1.0f / cjj;
#pragma unroll
      for (int r = j + 1; r < NB; ++r) {
        float e = S[r][j];
#pragma unroll
        for (int k = 0; k < j; ++k) e = e - C[r][k] * C[j][k];
        C[r][j] = e * inv;
      }
    }

    // Forward-substitution inverse of the lower-triangular C, into cp.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      cp[j][j] = 1.0f / C[j][j];
#pragma unroll
      for (int r = j + 1; r < NB; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int k = j; k < r; ++k) acc = acc + C[r][k] * cp[k][j];
        cp[r][j] = -acc / C[r][r];
      }
#pragma unroll
      for (int r = 0; r < j; ++r) cp[r][j] = 0.f;
    }
    float* Co = cinv + i * knot;
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) Co[at(r, c)] = cp[r][c];
  }
}

template <int NB>
int launch_factor(const float* diag, const float* offp, float* cinv,
                  float* w, int n, int batch, cudaStream_t stream) {
  fused_factor_kernel<NB><<<scenario_blocks(batch), kScenarioThreads, 0,
                            stream>>>(diag, offp, cinv, w, n, batch);
  return launch_status();
}

}  // namespace pathopt

extern "C" {

// Returns the cudaError_t of the launch (0 on success); an nb other than
// 3, 4 or 6 returns cudaErrorInvalidValue without launching.
int pathopt_fused_factor(const float* diag, const float* offp, float* cinv,
                         float* w, int n, int nb, int batch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 3: return pathopt::launch_factor<3>(diag, offp, cinv, w, n, batch, s);
    case 4: return pathopt::launch_factor<4>(diag, offp, cinv, w, n, batch, s);
    case 6: return pathopt::launch_factor<6>(diag, offp, cinv, w, n, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* pathopt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
