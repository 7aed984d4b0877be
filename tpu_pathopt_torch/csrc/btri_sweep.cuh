// Device functions shared by the ADMM-round kernels K2 and K3: one thread
// block (CTA) per scenario, one thread per knot, the whole round resident in
// shared memory and registers.
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
// __shfl_sync, and every operand is read from shared memory.
//
// Shared memory of one CTA, in floats, for n knots:
//   G, H  (n, nb, nb) row-major per knot   read by the sweep lanes
//   D     (n, nb)                          d, then y, then e, then vt
//   X     (nb, n)                          a vector handed to knot i-1
//   ci    (nb (nb + 1) / 2, n)             lower triangle of Cinv_i
// then the kernel's own per-knot blocks ((k, n) element-major, so thread i
// reading element k of its knot hits bank (k n + i) mod 32 without
// conflicts) and a fixed tail. fused_rounds.round_smem_bytes in Python
// computes the same size; the launchers refuse any other.
#pragma once

#include "common.cuh"

namespace pathopt {

// One thread per knot: at most this many knots per CTA. With 256 threads the
// compiler may give each thread up to 255 registers (at 512, 128).
constexpr int kMaxRoundThreads = 256;
constexpr int kMaxRoundWarps = kMaxRoundThreads / 32;

__host__ __device__ constexpr int tri_size(int nb) { return nb * (nb + 1) / 2; }

// (r, j), j <= r, of a lower triangle packed by rows.
__host__ __device__ constexpr int tri(int r, int j) { return r * (r + 1) / 2 + j; }

inline int round_threads(int n) { return (n + 31) / 32 * 32; }

inline size_t round_smem_bytes(int n, int nb, int knot_floats,
                               int tail_floats) {
  const size_t per_knot = 2 * nb * nb + 2 * nb + tri_size(nb) + knot_floats;
  return (per_knot * n + tail_floats) * sizeof(float);
}

// The launch configuration check: 0 if it is valid, else the error to
// return without launching.
inline int round_config_error(int n, int batch, size_t need, int smem_bytes) {
  if (n < 1 || batch < 1 || round_threads(n) > kMaxRoundThreads ||
      need != static_cast<size_t>(smem_bytes) || smem_bytes > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int NB>
struct SweepSmem {
  float* G;
  float* H;
  float* D;
  float* X;
  float* ci;
  float* rest;  // the kernel's own blocks
  __device__ SweepSmem(float* s, int n)
      : G(s),
        H(s + NB * NB * n),
        D(s + 2 * NB * NB * n),
        X(s + (2 * NB * NB + NB) * n),
        ci(s + (2 * NB * NB + 2 * NB) * n),
        rest(s + (2 * NB * NB + 2 * NB + tri_size(NB)) * n) {}
};

// Load knot i's Cinv (its lower triangle) from device memory, where element
// (r, c) sits at ci_g[(r NB + c) stride], into registers and shared memory,
// and store G_i = Cinv_i Wp_i and H_i = Cinv_i^T Wp_{i+1}^T (a null Wp gives
// the zero block). One column of G and one row of Wp_{i+1} at a time, so
// that only NB of the Wp values are live at once.
template <int NB>
__device__ void load_knot_factors(const SweepSmem<NB>& S, int n, int i,
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
  float* G = S.G + i * NB * NB;
  float* H = S.H + i * NB * NB;
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
template <int NB>
__device__ __forceinline__ void store_ci_mul(const SweepSmem<NB>& S, int n,
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
template <int NB>
__device__ __forceinline__ void ci_t_mul_in_place(const SweepSmem<NB>& S,
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

// One sweep over the knots in the direction `step` (+1 forward from knot 0
// with M = G, -1 backward from knot n-1 with M = H): D_i = D_i - M_i D_prev.
// Called by lanes 0..NB-1 of one warp and no other thread.
// Each step's operands are loaded one step ahead, so that only the shuffles
// and the arithmetic lie on the dependent chain.
template <int NB>
__device__ __forceinline__ void sweep(const float* M, float* D, int n,
                                      int lane, bool forward) {
  constexpr unsigned mask = (1u << NB) - 1u;
  const int step = forward ? 1 : -1;
  int i = forward ? 0 : n - 1;
  float m[NB], d = D[i * NB + lane];
#pragma unroll
  for (int j = 0; j < NB; ++j) m[j] = M[(i * NB + lane) * NB + j];
  float x = 0.f;
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

// Both sweeps of one solve, D = d on entry and vt on return; every thread
// of the CTA calls it. The barriers separate the sweeps from the parallel
// step between them and from the callers' phases.
template <int NB>
__device__ __forceinline__ void solve_in_place(const SweepSmem<NB>& S, int n,
                                               int i) {
  if (threadIdx.x < NB) sweep<NB>(S.G, S.D, n, threadIdx.x, true);
  __syncthreads();
  if (i < n) ci_t_mul_in_place<NB>(S, n, i);
  __syncthreads();
  if (threadIdx.x < NB) sweep<NB>(S.H, S.D, n, threadIdx.x, false);
  __syncthreads();
}

// nanmax over the 32 lanes of a warp (every lane gets the result).
__device__ __forceinline__ float warp_nanmax(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace pathopt
