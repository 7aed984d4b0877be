// K7: the prep stage (pipeline._prep: the B-spline fit of the raw points
// and the 1 m segmentation of the fitted route), one CTA a scenario.
//
// Replaces: tpu_pathopt/bspline.py, fit_and_sample, and
// tpu_pathopt/smoothing/segment.py, segment_raw_reference. These are no
// Pallas kernels: the JAX package runs the three de Boor ladders under
// lax.switch, the spline's tridiagonal solve as associative scans and the
// evaluations as XLA code. The port issued the same stage from the host as
// about 3,300 small PyTorch kernels (the natural spline's Thomas sweeps
// over the bspline_samples knots, about 8 kernels a knot; the three de Boor
// ladders; the evaluations), and in the compiled call their number, not
// their work, set the stage's time: about 5 ms at B 256 and 4 ms at B 1,
// 43% of the B 1 call. This kernel runs all of it in one launch.
//
// For each scenario (every array batch-leading; the CTA's threads stride
// over the rows of each phase):
//  1. the raw route's length (warp 0: the R - 1 segments summed in
//     PyTorch's CUDA reduction order, below) and the degree its average
//     spacing picks (3 past 10 m, 4 past 5 m, else 5);
//  2. the T samples (one a thread) at t = i / max(length, 1) up to
//     ceil(length), then 1: only that degree's de Boor ladder (the chain
//     runs all three and keeps this one with a `where`);
//  3. the samples' arc length: their segments (0 past the valid samples),
//     summed in float64 in index order and rounded once to float32
//     (splines.cuh's arc_length, thread 0);
//  4. the natural cubic spline of x and y on those knots (splines.cuh's
//     fit_knots: the sequential Thomas sweeps of x and y on threads 0 and 1,
//     then one segment's coefficients a thread);
//  5. the P stations at 1 m, s = min(i, n_valid - 1) with n_valid =
//     min(ceil(the arc length's end) + 1, P) (one a thread): x, y, heading
//     and curvature (splines.cuh's evaluation, a binary search of the knots),
//     the last station up to 1 m past the fit, by linear extrapolation.
//
// Numerics: bit for bit the plain chain on the card, by the rules of
// splines.cuh. Besides them: the length's float32 sum follows PyTorch's
// CUDA reduction of a contiguous row of R - 1 <= 127 values (Reduce.cuh: w
// = min(the largest power of two <= R - 1, 32) lanes, lane j summing
// elements j + w q into accumulator q mod 4 in order of q, the four added
// in order, then the lanes' tree by shuffles at offsets w / 2, ..., 2, 1;
// held to torch.sum on the card for every row length up to 127; at 128
// values PyTorch vectorizes its loads and sums in another order, so the
// plan stops there), every division by a tensor is a correctly
// rounded division, and an int64 count is rounded to float32 where the
// chain converts it. A route whose raw points make the chain gather out of
// range (n_raw < 1, or more valid points than R) reads 0 there.
//
// What bounds it on the H100: not bytes. A scenario reads 2 R floats and
// writes 5 P + 2 values: about 1 us of HBM at B 256. The chain bounds it:
// the float64 sum (T - 1 dependent adds) and the Thomas sweep's forward and
// backward passes (2 T dependent steps, each forward one two divisions);
// the de Boor ladders and the stations spread over the CTA. At B <= about
// 1,000 every CTA is resident at once, so the launch takes about one
// scenario's chain at B 1 as at B 256.
//
// What the design does about it: the whole stage is one CTA, so nothing
// between phases leaves the SM: the raw points, the samples' spline table
// and the sweeps sit in shared memory; the serial parts run on one thread
// (the sum) or two (the x and y sweeps together); everything else spreads
// over the CTA. Launch plan (pipeline.prep_plan, checked here): threads =
// max(T, P) rounded up to a warp, at most 512; dynamic shared memory
// 4 (16 T + 2 R) bytes.
#include <cmath>

#include "common.cuh"
#include "splines.cuh"

namespace pathopt {

// The arguments, field for field kernels.PrepArgs.
struct PrepArgs {
  // The raw points (B, R) and their count (B,) int64.
  const float* raw_x;
  const float* raw_y;
  const long long* n_raw;
  // Outputs: ok_input (B,) bool; out (5, B, P): x, y, s, heading,
  // curvature at the stations; n_valid (B,) int64.
  unsigned char* ok_input;
  float* out;
  long long* n_valid;
  int batch;
  int R;
  int T;
  int P;
};

// The launch plan's limits (pipeline.PREP_MAX_*, PREP_MAX_THREADS).
constexpr int kPrepMaxRaw = 128;
constexpr int kPrepMaxSamples = 1024;
constexpr int kPrepMaxPoints = 1024;
constexpr int kPrepMaxThreads = 512;

inline int prep_threads(int T, int P) {
  const int t = ((T > P ? T : P) + 31) / 32 * 32;
  return t > kPrepMaxThreads ? kPrepMaxThreads : t;
}

inline size_t prep_smem_bytes(int R, int T) {
  return 4 * (16 * static_cast<size_t>(T) + 2 * static_cast<size_t>(R));
}

namespace {

// A scenario's scalars.
struct PrepLane {
  Ends e;
  float length;          // the raw route's
  long long n_interior;  // samples before t reaches 1
  long long n_samples;   // valid samples, n_interior + 1
  long long n_valid;     // valid stations
  int degree;
};

// Raw point k of a route with R of them, 0 outside (the chain's gather
// would be out of range there).
__device__ __forceinline__ float raw_at(const float* r, long long k, int R) {
  return k >= 0 && k < R ? r[k] : 0.f;
}

// bspline._knot_value at index i.
__device__ __forceinline__ float knot_value(long long i, float degree,
                                            float denom) {
  return clip(f_div(f_sub(static_cast<float>(i), degree), denom), 0.f, 1.f);
}

// bspline._de_boor of degree D at t for one sample: the clamped uniform
// B-spline of the nr control points (rx, ry) at t, into (x, y).
template <int D>
__device__ void de_boor(const float* rx, const float* ry, int R,
                        long long nr, float t, float& x, float& y) {
  const long long nd = nr - D;
  const float denom = static_cast<float>(nd < 1 ? 1 : nd);
  long long k = static_cast<long long>(floorf(f_mul(t, denom))) + D;
  k = k < D ? D : k;
  k = k < nr - 1 ? k : nr - 1;
  float dx[D + 1], dy[D + 1];
#pragma unroll
  for (int j = 0; j <= D; ++j) {
    dx[j] = raw_at(rx, k + j - D, R);
    dy[j] = raw_at(ry, k + j - D, R);
  }
  const float fd = static_cast<float>(D);
#pragma unroll
  for (int r = 1; r <= D; ++r) {
    // Every new value reads the ladder's previous row: from the top down.
#pragma unroll
    for (int j = D; j >= r; --j) {
      const float lo = knot_value(j + k - D, fd, denom);
      const float hi = knot_value(j + 1 + k - r, fd, denom);
      const float den = f_sub(hi, lo);
      const float alpha =
          fabsf(den) < kHessFloor ? 0.f : f_div(f_sub(t, lo), den);
      const float beta = f_sub(1.f, alpha);
      dx[j] = f_add(f_mul(beta, dx[j - 1]), f_mul(alpha, dx[j]));
      dy[j] = f_add(f_mul(beta, dy[j - 1]), f_mul(alpha, dy[j]));
    }
  }
  x = dx[D];
  y = dy[D];
}

// The raw route's segment e (0 where e + 1 is not a valid point).
__device__ __forceinline__ float raw_segment(const float* rx, const float* ry,
                                             int e, long long nr) {
  return e + 1 < nr ? hypotf(f_sub(rx[e + 1], rx[e]), f_sub(ry[e + 1], ry[e]))
                    : 0.f;
}

// torch.sum of the R - 1 raw segments in PyTorch's CUDA order (see the
// head of this file), by warp 0; lane 0 returns it.
__device__ float raw_length(const float* rx, const float* ry, int R,
                            long long nr, int lane) {
  const int n = R - 1;
  int w = 1;
  while (2 * w <= n && w < 32) w *= 2;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  if (lane < w) {
    for (int e = lane; e < n; e += 4 * w) {
      acc0 = f_add(acc0, raw_segment(rx, ry, e, nr));
      if (e + w < n) acc1 = f_add(acc1, raw_segment(rx, ry, e + w, nr));
      if (e + 2 * w < n)
        acc2 = f_add(acc2, raw_segment(rx, ry, e + 2 * w, nr));
      if (e + 3 * w < n)
        acc3 = f_add(acc3, raw_segment(rx, ry, e + 3 * w, nr));
    }
  }
  float v = f_add(f_add(f_add(acc0, acc1), acc2), acc3);
  for (int o = w >> 1; o > 0; o >>= 1)
    v = f_add(v, __shfl_down_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kPrepMaxThreads) prep_kernel(
    const PrepArgs a) {
  extern __shared__ float smem[];
  __shared__ PrepLane sh;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int R = a.R, T = a.T, P = a.P;
  float* tab = smem;              // T rows: the samples' spline
  float* work = tab + kRow * T;   // the segments and the fit's sweeps, 7 T
  float* rx = work + 7 * T;       // the raw points
  float* ry = rx + R;

  const long long nr = a.n_raw[b];
  for (int k = tid; k < R; k += nt) {
    rx[k] = a.raw_x[static_cast<size_t>(b) * R + k];
    ry[k] = a.raw_y[static_cast<size_t>(b) * R + k];
  }
  __syncthreads();

  // 1. The length, the degree and the samples' count.
  if (tid < 32) {
    const float length = raw_length(rx, ry, R, nr, tid);
    if (tid == 0) {
      const long long n1 = nr - 1;
      const float avg =
          f_div(length, static_cast<float>(n1 < 1 ? 1 : n1));
      sh.length = length;
      sh.degree = avg > 10.f ? 3 : (avg > 5.f ? 4 : 5);
      long long ni = static_cast<long long>(ceilf(length));
      ni = ni < T - 1 ? ni : T - 1;
      sh.n_interior = ni;
      sh.n_samples = ni + 1;
      a.ok_input[b] = nr >= 4;
    }
  }
  __syncthreads();

  // 2. The samples, by the degree's ladder.
  const float length = sh.length;
  const float span = nanmax(length, 1.f);
  const float n_interior = static_cast<float>(sh.n_interior);
  const int degree = sh.degree;
  for (int i = tid; i < T; i += nt) {
    const float fi = static_cast<float>(i);
    const float t = fi < n_interior ? f_div(fi, span) : 1.f;
    float* r = tab + kRow * i;
    if (degree == 3)
      de_boor<3>(rx, ry, R, nr, t, r[1], r[5]);
    else if (degree == 4)
      de_boor<4>(rx, ry, R, nr, t, r[1], r[5]);
    else
      de_boor<5>(rx, ry, R, nr, t, r[1], r[5]);
  }
  __syncthreads();

  // 3. Their arc length.
  const long long nv = sh.n_samples;
  for (int j = tid; j < T - 1; j += nt) {
    const float* r = tab + kRow * j;
    work[j] = j + 1 < nv ? hypotf(f_sub(r[kRow + 1], r[1]),
                                  f_sub(r[kRow + 5], r[5]))
                         : 0.f;
  }
  __syncthreads();
  arc_length(tab, T, work);
  __syncthreads();

  // 4. The spline on those knots.
  const bool sorted = fit_knots(tab, T, nv, work);
  if (tid == 0) {
    sh.e = make_ends(tab, T, nv, sorted);
    const long long n = static_cast<long long>(ceilf(sh.e.s_hi)) + 1;
    sh.n_valid = n < P ? n : P;
    a.n_valid[b] = sh.n_valid;
  }
  __syncthreads();

  // 5. The stations.
  const Ends e = sh.e;
  const float last = static_cast<float>(sh.n_valid - 1);
  const size_t plane = static_cast<size_t>(a.batch) * P;
  float* out = a.out + static_cast<size_t>(b) * P;
  for (int i = tid; i < P; i += nt) {
    const float q = fminf(static_cast<float>(i), last);
    const Point p = eval_thread(tab, e, q);
    out[i] = p.x;
    out[plane + i] = p.y;
    out[2 * plane + i] = q;
    out[3 * plane + i] = atan2f(p.dy, p.dx);
    out[4 * plane + i] = curvature(p);
  }
}

}  // namespace

// 0 if the arguments and plan are what the kernel takes, else
// cudaErrorInvalidValue.
int prep_error(const PrepArgs& a, int threads, int smem_bytes) {
  if (a.batch < 1 || a.R < 2 || a.R > kPrepMaxRaw || a.T < 2 ||
      a.T > kPrepMaxSamples || a.P < 1 || a.P > kPrepMaxPoints ||
      threads != prep_threads(a.T, a.P) ||
      static_cast<size_t>(smem_bytes) != prep_smem_bytes(a.R, a.T) ||
      smem_bytes > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). The plan comes from
// pipeline.prep_plan: threads = prep_threads(T, P), smem_bytes =
// prep_smem_bytes(R, T); a plan or shape the kernel does not take is
// refused with cudaErrorInvalidValue without running.
extern "C" int pathopt_prep(const pathopt::PrepArgs* a, int threads,
                            int smem_bytes, void* stream) {
  const int err = pathopt::prep_error(*a, threads, smem_bytes);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      pathopt::prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  pathopt::prep_kernel<<<a->batch, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return pathopt::launch_status();
}
