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
// writes about 17 MB and does about 30 MFLOP, far below either roof: what
// bounds it is the latency of one knot's chain times N: its loads, the nb
// dependent square roots and reciprocals of the Crout, and the
// instructions of one warp, which has an SM nearly to itself.
//
// What the design does about it: a scenario gets a group of 16 lanes
// (nb 9, the TENSION QP), 8 (nb 6) or 4 (nb 3, 4), lane r owning block row
// r, and one warp (one block) holds 2, 4 or 8 neighbouring scenarios, so
// B = 256 is 128, 64 or 32 blocks and each load or store of a warp covers
// neighbouring floats of its scenarios. At nb 9 seven lanes of each group
// idle and every lane holds the 45 floats of Cinv's lower triangle and the
// 36 of C's below the diagonal.
// - Load ahead: lane r copies its own row of Off_i and of D_i (c <= r) into
//   a ring of kRing knots in shared memory with cp.async, kRing - 1 knots
//   ahead of the chain; a lane reads only what it copied, so no barrier.
// - Rows in parallel: lane r forms row r of W_i (nb-term sums against
//   Cinv_{i-1}, which every lane holds) and row r of S_i; the rows meet in
//   shared memory behind __syncwarp (twice a knot).
// - The chain: every lane of the scenario factors the whole nb x nb block
//   and inverts it, redundantly, in registers, so the Crout columns and
//   the inverse need no communication, and each lane ends the knot holding
//   all of Cinv_i for the next W. The pivot's reciprocal is the hardware
//   rsqrt of the floored pivot (rsqrtf, within 2 ulp; the correctly
//   rounded __frsqrt_rn is a long sequence on the chain, and made the
//   launch markedly longer; the Cholesky diagonal itself is never needed),
//   and the inverse multiplies by it instead of dividing: no division is
//   left on the chain.
// - Store behind: a knot's outputs go to a per-lane staging ring in shared
//   memory, and every kFlush knots the lane writes them to device memory
//   in one burst. Stores issued inside the chain made the launch markedly
//   longer (an A/B on the card, PERF.md section 6): each covers only 4 or
//   8 scenarios, so one warp store touches 6 lines, and the shared-memory
//   loads of the next step wait behind it.
// - Sums run in the plain version's order (fused_rounds.fma_sum: the
//   first two products as fma(x0, y0, x1 y1), then one fma per term; the
//   W sums skip the zero products of the triangular Cinv, which changes
//   no finite sum). Only the reciprocals differ from it: rsqrt in place of
//   sqrt then 1/x, and -acc * (1/C_aa) in place of -acc / C_aa.
//   tests/test_torch_kernels.py models this order on the CPU.
// - Kept: the floor sqrt(max(d, 1e-12)) with NaN propagating as jnp.maximum
//   does, W_0 = 0, nb templated over {3, 4, 6, 9}, any B (a ragged last group
//   recomputes the last scenario and stores nothing), each output written
//   once.
#include "common.cuh"

namespace pathopt {

constexpr float kPivotFloor = 1e-12f;

// max(a, b), NaN if either is NaN (jnp.maximum), in one instruction.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int NB>
struct FactorLayout {
  // lanes per scenario: a power of two >= NB, so groups tile the warp
  static constexpr int kLanes = NB > 8 ? 16 : NB > 4 ? 8 : 4;
  static constexpr int kScen = 32 / kLanes;         // scenarios per block
  static constexpr int kRing = 8;                   // knots of input in flight
  static constexpr int kFlush = 8;                  // knots of output staged
  static constexpr int kSlot = 2 * NB;              // a lane's floats per knot
  // W and S rows of one scenario; an odd stride keeps the scenarios of a
  // warp on different banks.
  static constexpr int kXch = (2 * NB * NB) | 1;
};

template <int NB>
__global__ void __launch_bounds__(32)
fused_factor_kernel(const float* __restrict__ diag,
                    const float* __restrict__ offp,
                    float* __restrict__ cinv, float* __restrict__ wout,
                    int n, int batch) {
  using L = FactorLayout<NB>;
  __shared__ float ring[L::kRing * L::kSlot * 32];
  __shared__ float xch[L::kScen * L::kXch];
  __shared__ float staged[L::kFlush * L::kSlot * 32];  // W row, Cinv row
  const int lane = threadIdx.x;
  const int s = lane / L::kLanes;
  const int r = lane % L::kLanes;
  const int b = blockIdx.x * L::kScen + s;
  const bool owns_row = r < NB;
  const bool stores = owns_row && b < batch;
  const int bl = b < batch ? b : batch - 1;
  const size_t knot = static_cast<size_t>(NB) * NB * batch;
  const size_t row = static_cast<size_t>(r) * NB * batch;  // element (r, 0)
  float* Wx = xch + s * L::kXch;  // row-major W_i of this scenario
  float* Sx = Wx + NB * NB;       // row-major S_i, lower triangle

  // Copy lane r's rows of knot i into its ring slot (one group per call,
  // empty past the end, so the count of groups in flight stays uniform).
  auto issue = [&](int i) {
    if (owns_row && i < n) {
      float* dst = ring + (i % L::kRing) * L::kSlot * 32 + lane;
      const float* O = offp + i * knot + row + bl;
      const float* D = diag + i * knot + row + bl;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        cp_async4(dst + c * 32, O + static_cast<size_t>(c) * batch);
        if (c <= r)
          cp_async4(dst + (NB + c) * 32, D + static_cast<size_t>(c) * batch);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < L::kRing - 1; ++i) issue(i);

  float cp[NB][NB];  // Cinv of the previous knot, then of this knot
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int c = 0; c < NB; ++c) cp[a][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    issue(i + L::kRing - 1);
    cp_async_wait<L::kRing - 1>();
    const float* in = ring + (i % L::kRing) * L::kSlot * 32 + lane;
    float* st = staged + (i % L::kFlush) * L::kSlot * 32 + lane;

    // Row r of W = O Cinv_prev^T: W[r][c] = sum_{j <= c} O[r][j] Cp[c][j].
    // Lanes past the last row compute garbage and store nothing; keeping
    // every lane on one path avoids divergent branches.
    float w[NB];
    {
      float o[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) o[j] = in[j * 32];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = c ? fmaf(o[0], cp[c][0], o[1] * cp[c][1])
                      : o[0] * cp[c][0];
#pragma unroll
        for (int j = 2; j <= c; ++j) acc = fmaf(o[j], cp[c][j], acc);
        w[c] = acc;
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (owns_row) Wx[r * NB + c] = w[c];
      st[c * 32] = w[c];
    }
    __syncwarp();

    // Row r of S = D - W W^T. The entries above the diagonal are computed
    // from ring words that hold no D and never read.
    {
      float srow[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float acc = fmaf(w[0], Wx[c * NB], w[1] * Wx[c * NB + 1]);
#pragma unroll
        for (int j = 2; j < NB; ++j) acc = fmaf(w[j], Wx[c * NB + j], acc);
        srow[c] = in[(NB + c) * 32] - acc;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (owns_row) Sx[r * NB + c] = srow[c];
    }
    __syncwarp();

    // Cholesky-Crout with the pivot floor, every lane the whole block;
    // inv[j] = 1 / C[j][j].
    float C[NB][NB], inv[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int a = j; a < NB; ++a) {
        float e = Sx[a * NB + j];
#pragma unroll
        for (int k = 0; k < j; ++k) e = fmaf(-C[a][k], C[j][k], e);
        if (a == j)
          inv[j] = rsqrtf(max_nan(e, kPivotFloor));
        else
          C[a][j] = e * inv[j];
      }
    }

    // Forward-substitution inverse into cp, column by column:
    // Cinv[a][j] = -(sum_{k=j}^{a-1} C[a][k] Cinv[k][j]) / C[a][a],
    // -(acc * inv) written as acc * (-inv), which rounds the same.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      cp[j][j] = inv[j];
#pragma unroll
      for (int a = j + 1; a < NB; ++a) {
        float acc = a > j + 1
                        ? fmaf(C[a][j], cp[j][j], C[a][j + 1] * cp[j + 1][j])
                        : C[a][j] * cp[j][j];
#pragma unroll
        for (int k = j + 2; k < a; ++k) acc = fmaf(C[a][k], cp[k][j], acc);
        cp[a][j] = acc * -inv[a];
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      float v = 0.f;  // row r of Cinv, zero above the diagonal
#pragma unroll
      for (int a = c; a < NB; ++a) v = a == r ? cp[a][c] : v;
      st[(NB + c) * 32] = v;
    }

    // Write the staged knots out, off the chain (a lane reads back only
    // what it staged itself).
    if (stores && (i % L::kFlush == L::kFlush - 1 || i == n - 1)) {
      for (int k = i - i % L::kFlush; k <= i; ++k) {
        const float* src = staged + (k % L::kFlush) * L::kSlot * 32 + lane;
        const size_t out = k * knot + row + b;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          wout[out + static_cast<size_t>(c) * batch] = src[c * 32];
          cinv[out + static_cast<size_t>(c) * batch] = src[(NB + c) * 32];
        }
      }
    }
  }
}

template <int NB>
int launch_factor(const float* diag, const float* offp, float* cinv,
                  float* w, int n, int batch, cudaStream_t stream) {
  if (n < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int scen = FactorLayout<NB>::kScen;
  fused_factor_kernel<NB><<<(batch + scen - 1) / scen, 32, 0, stream>>>(
      diag, offp, cinv, w, n, batch);
  return launch_status();
}

}  // namespace pathopt

extern "C" {

// Returns the cudaError_t of the launch (0 on success); an nb other than
// 3, 4, 6 or 9 returns cudaErrorInvalidValue without launching.
int pathopt_fused_factor(const float* diag, const float* offp, float* cinv,
                         float* w, int n, int nb, int batch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 3: return pathopt::launch_factor<3>(diag, offp, cinv, w, n, batch, s);
    case 4: return pathopt::launch_factor<4>(diag, offp, cinv, w, n, batch, s);
    case 6: return pathopt::launch_factor<6>(diag, offp, cinv, w, n, batch, s);
    case 9: return pathopt::launch_factor<9>(diag, offp, cinv, w, n, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* pathopt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
