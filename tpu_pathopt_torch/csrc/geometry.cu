// K5: the geometry stage (pipeline._geometry, which the JAX package times
// as `bounds`), one CTA a scenario.
//
// Replaces: tpu_pathopt/refpath.py, build_reference_from_spline (lax.scan at
// :97), and tpu_pathopt/bounds.py, update_bounds. These are no Pallas
// kernels: XLA compiles the JAX package's scan, Newton loops and ESDF
// marches into a few device loops. The port issued the same stage from the
// host as about 24,000 small PyTorch kernels (128 knots of the resample
// recurrence, each a whole spline evaluation; the Newton projections; the
// Thomas sweeps of the refit; the marches), and in the compiled call their
// number, not their work, set the stage's time: 27 ms at B 1, 35 ms at
// B 256. This kernel runs the whole stage in one launch.
//
// For each scenario (every array batch-leading; the CTA's threads stride
// over the rows of each phase):
//  1. re-projection: the smoothed route (xs2, ys2: S knots, one packed
//     table in shared memory) at the corridor's M layers, offset by the
//     post-smoothed l along its normal (one layer a thread);
//  2. refit (splines.refit): the polyline's segments, their arc
//     length summed in float64 and rounded once to float32 (thread 0), the
//     natural-BC Thomas sweep of x and y (lanes 0 and 1), the cubic
//     coefficients (one segment a thread): the table xs3, ys3;
//  3. init state and trim: the start pose against the refit's first point
//     and the target's projection (splines.project: 256 grid candidates,
//     one a thread, a first argmin over the CTA, then Newton in warp 0);
//  4. the resample (refpath.build_reference_from_spline): with dynamic
//     segmentation N dependent steps, each a spline evaluation, in warp 0;
//  5. the states at the N knots (one a thread); for each (axle, knot) the
//     directional Newton projection (and the 21-point grid pre-scan where
//     directional_prescan_fallback is set), the ESDF clearance of both sides
//     (bounds.clearance_strict: 20 coarse and 5 fine bilinear probes a
//     side) and the bounds; the centre corridor where
//     rough_constraints_far_away is set;
//  6. the blocked truncation: the first zero-width knot (a shared atomicMin).
//
// Numerics: bit for bit the plain chain on the card, by the rules of
// splines.cuh (the spline evaluation, the refit, the trim's projection and
// the ESDF's reads live there, shared with K6), and here too: fmodf is the
// precise libdevice function, and a division by a Python number d is
// PyTorch's multiply by 1 / d taken in double and rounded to float32 (the
// curvature ramp's x / 0.12, max_s / ds: at 0.12 that reciprocal is not
// float32's 1 / 0.12f, and a division or the float32 reciprocal differs
// from the chain in most elements).
//
// What bounds it on the H100: the bytes are few (a scenario's tables, 9 S +
// 3 M floats, its 15 N outputs; the ESDF's packed stencils, 1.4 MB on the
// 60 m map and 8 MB on the long route's, read once into L2 and probed there
// 52 times an axle and knot), so about 3 us at B 256. The chain bounds it:
// N dependent resample steps, each a segment search, about 40 dependent
// float operations, a powf and a division, then 2 x 12 dependent Newton
// steps and the ESDF probes, in each CTA; at B <= about 500 every CTA is
// resident at once, so the launch takes one scenario's chain at B 1 as at
// B 256.
//
// What the design does about it: the whole stage is one CTA, so nothing
// between phases leaves the SM: both spline tables, the refit's sweeps
// and the knots' states sit in shared memory, and the only device-memory
// reads after the first loads are the ESDF probes (L2). The sequential
// parts run on one warp with the segment search spread over its lanes
// (a ballot over 32 knots at a time); everything else spreads over the
// CTA, and each side's 20 coarse probes are issued together (no early
// exit) so their L2 reads overlap. Launch plan (pipeline.geometry_plan,
// checked here): threads = 2 N rounded up to a warp, within [128, 512];
// dynamic shared memory 4 (9 S + 16 M + 4 N + 64) bytes.
#include <cmath>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "splines.cuh"

namespace pathopt {

// The arguments, field for field kernels.GeometryArgs.
struct GeoArgs {
  // xs2 and ys2 on one knot vector: the knots, x's values and a, b, c,
  // y's values and a, b, c ((B, S), (B, S - 1)); n_valid (B,) int64.
  const float* s2;
  const float* x2;
  const float* x2a;
  const float* x2b;
  const float* x2c;
  const float* y2;
  const float* y2a;
  const float* y2b;
  const float* y2c;
  const long long* n2;
  // The corridor's layers and the post-smoothed offsets (B, M), its valid
  // layers (B,) int64.
  const float* layers_s;
  const float* l_post;
  const long long* n_layers;
  // Start and target poses (B,).
  const float* start_x;
  const float* start_y;
  const float* start_heading;
  const float* target_x;
  const float* target_y;
  // The map's packed bilinear stencils ((rows - 1) (c_pad - 1), 4).
  const float* quad;
  // Outputs: ref (5, B, N): x, y, heading, k, s; bnd (10, B, N): front lb,
  // ub, rear lb, ub, centre lb, ub, front x, y, rear x, y; init (2, B):
  // offset, heading error; n_valid (B,) int64; flags (3, B) bool:
  // truncated, blocked, ok_init.
  float* ref;
  float* bnd;
  float* init;
  long long* n_valid;
  unsigned char* flags;
  int batch;
  int S;
  int M;
  int N;
  int n_rows;
  int n_cols;
  int c_pad;
  int newton_iters;
  int dynamic;
  int prescan;
  int with_center;
  // Float32 roundings of the chain's Python numbers (the reciprocals taken
  // in double, as PyTorch takes them).
  float row_c;
  float col_c;
  float inv_res;
  float half_x;
  float half_y;
  float ds;
  float ds_shrink;
  float inv_k_span;
  float inv_ds;
  float full_s;
  float front_len;
  float rear_len;
  float diff_radius;
  float safety_margin;
  float epsilon;
  float init_limit;
};

// The launch plan's limits (pipeline.GEO_MAX_*, GEO_MIN_THREADS).
constexpr int kGeoMaxSegmentPoints = 1024;
constexpr int kGeoMaxLayers = 1024;
constexpr int kGeoMaxKnots = 4096;
constexpr int kGeoMaxThreads = 512;
constexpr int kGeoMinThreads = 128;

inline int geometry_threads(int N) {
  const int t = (2 * N + 31) / 32 * 32;
  return t < kGeoMinThreads ? kGeoMinThreads
                            : (t > kGeoMaxThreads ? kGeoMaxThreads : t);
}

inline size_t geometry_smem_bytes(int S, int M, int N) {
  return 4 * (9 * static_cast<size_t>(S) + 16 * static_cast<size_t>(M) +
              4 * static_cast<size_t>(N) + 64);
}

namespace {

// Python doubles rounded to float32, as PyTorch rounds a scalar operand.
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kHalfPi = static_cast<float>(3.141592653589793 / 2);
// bounds.py
constexpr float kSearchRadius = static_cast<float>(0.5);
constexpr float kCoarseDs = static_cast<float>(0.3);
constexpr float kFineDs = static_cast<float>(0.05);
constexpr int kCoarseSteps = 20;
constexpr int kFineSteps = 5;
constexpr float kCoarseLast = static_cast<float>(19 * 0.3);
constexpr float kMinCorridor = static_cast<float>(0.2);
constexpr float kProjReach = static_cast<float>(5.0);  // ref.s + 5, ref.s - 5
// refpath.py's ramp start.
constexpr float kSmallK = static_cast<float>(0.08);
// bounds.py's directional pre-scan (from ref.s - 5, 0.5 m apart).
constexpr int kDirGrid = 21;
constexpr float kDirGridDs = static_cast<float>(0.5);

// geometry.constrain_angle: torch.remainder(a + pi, 2 pi) - pi.
__device__ __forceinline__ float constrain_angle(float a) {
  float r = fmodf(f_add(a, kPi), kTwoPi);
  if (r != 0.f && r < 0.f) r = f_add(r, kTwoPi);
  return f_sub(r, kPi);
}

// One side of bounds.clearance_strict: the march's drivable extent along
// `ang` from (x, y). Every coarse probe is read (the first violation is
// picked after), so their reads overlap.
__device__ float side_extent(const GeoArgs& a, float x, float y, float ang) {
  const float c = cosf(ang), s = sinf(ang);
  int hits = kCoarseSteps;
#pragma unroll
  for (int i = 1; i <= kCoarseSteps; ++i) {
    const float d = f_mul(static_cast<float>(i), kCoarseDs);
    const bool bad =
        esdf(a, f_add(x, f_mul(d, c)), f_add(y, f_mul(d, s))) < kSearchRadius;
    if (bad && hits == kCoarseSteps) hits = i - 1;
  }
  const float base = hits < kCoarseSteps
                         ? f_mul(static_cast<float>(hits), kCoarseDs)
                         : kCoarseLast;
  int good = kFineSteps;
#pragma unroll
  for (int i = 1; i <= kFineSteps; ++i) {
    const float d = f_add(base, f_mul(static_cast<float>(i), kFineDs));
    const bool bad =
        esdf(a, f_add(x, f_mul(d, c)), f_add(y, f_mul(d, s))) < kSearchRadius;
    if (bad && good == kFineSteps) good = i - 1;
  }
  return f_add(base, f_mul(static_cast<float>(good), kFineDs));
}

// bounds.clearance_strict at one state: (left, right), or (0, 0) where the
// state is in collision or the corridor collapses.
__device__ void clearance(const GeoArgs& a, float x, float y, float h,
                          float& left_out, float& right_out) {
  const bool ok = esdf(a, x, y) > kSearchRadius;
  float left = f_sub(side_extent(a, x, y, f_add(h, kHalfPi)), a.diff_radius);
  float right =
      -f_sub(side_extent(a, x, y, f_sub(h, kHalfPi)), a.diff_radius);
  const bool collapsed = left < right;
  const float max_margin =
      nanmax(f_mul(f_sub(f_sub(left, right), kMinCorridor), kHalf), 0.f);
  const float margin = nanmin(max_margin, a.safety_margin);
  left = f_sub(left, margin);
  right = f_add(right, margin);
  const bool invalid = !ok || collapsed;
  left_out = invalid ? 0.f : left;
  right_out = invalid ? 0.f : right;
}

// splines.project_directional_newton from `hint` (v1, v2 = sin, -cos of
// the ray's angle).
__device__ float dir_newton(const float* tab, const Ends& e, float tx,
                           float ty, float v1, float v2, float max_s,
                           float hint, int iters) {
  float cur = nanmin(hint, max_s);
  for (int it = 0; it < iters; ++it) {
    const Point p = eval_thread(tab, e, cur);
    const float p1 =
        f_add(f_mul(v1, f_sub(p.x, tx)), f_mul(v2, f_sub(p.y, ty)));
    const float p2 = f_add(f_mul(v1, p.dx), f_mul(v2, p.dy));
    const float hes = f_add(
        f_mul(p1, f_add(f_mul(v1, p.ddx), f_mul(v2, p.ddy))), f_mul(p2, p2));
    cur = f_sub(cur, f_div(f_mul(p1, p2), guard(hes)));
  }
  return nanmin(cur, max_s);
}

// splines.directional_ray_residual, NaN read as infinitely far.
__device__ float ray_residual(const float* tab, const Ends& e, float tx,
                              float ty, float sa, float ca, float s) {
  const Point p = eval_thread(tab, e, s);
  const float r =
      fabsf(f_sub(f_mul(sa, f_sub(p.x, tx)), f_mul(ca, f_sub(p.y, ty))));
  return r != r ? INFINITY : r;
}

// A scenario's scalars.
struct Lane {
  Ends e2, e3;
  float max_s;   // the trimmed length
  int best;      // an argmin's winner
  int count;     // resampled knots <= max_s
  int first;     // the first zero-width knot, N if none
  int truncated;
};

__global__ void __launch_bounds__(kGeoMaxThreads)
    geometry_kernel(const GeoArgs a) {
  extern __shared__ float smem[];
  __shared__ Lane sh;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, M = a.M, N = a.N;
  float* tab2 = smem;                  // S rows: xs2, ys2
  float* tab3 = tab2 + kRow * S;       // M rows: xs3, ys3
  float* h3 = tab3 + kRow * M;         // the refit's sweeps, 7 M
  float* ks = h3 + 7 * M;              // the knots' s, x, y, heading
  float* kx = ks + N;
  float* ky = kx + N;
  float* kh = ky + N;
  float* red_v = kh + N;               // 32 + 32 words of reductions
  int* red_i = reinterpret_cast<int*>(red_v + 32);

  // The route's table, and whether its knots are non-decreasing.
  {
    const size_t o = static_cast<size_t>(b) * S;
    const size_t oc = static_cast<size_t>(b) * (S - 1);
    int unsorted = 0;
    for (int k = tid; k < S; k += nt) {
      float* r = tab2 + kRow * k;
      r[0] = a.s2[o + k];
      r[1] = a.x2[o + k];
      r[5] = a.y2[o + k];
      const bool seg = k < S - 1;
      r[2] = seg ? a.x2a[oc + k] : 0.f;
      r[3] = seg ? a.x2b[oc + k] : 0.f;
      r[4] = seg ? a.x2c[oc + k] : 0.f;
      r[6] = seg ? a.y2a[oc + k] : 0.f;
      r[7] = seg ? a.y2b[oc + k] : 0.f;
      r[8] = seg ? a.y2c[oc + k] : 0.f;
      if (seg) unsorted |= !(a.s2[o + k] <= a.s2[o + k + 1]);
    }
    if (tid == 0) {
      sh.count = 0;
      sh.first = N;
    }
    unsorted = __syncthreads_or(unsorted);
    if (tid == 0) sh.e2 = make_ends(tab2, S, a.n2[b], !unsorted);
    __syncthreads();
  }

  // 1. Re-projection at the corridor's layers.
  {
    const Ends e2 = sh.e2;
    for (int j = tid; j < M; j += nt) {
      const size_t o = static_cast<size_t>(b) * M + j;
      const Point p = eval_thread(tab2, e2, a.layers_s[o]);
      const float dir = atan2f(p.dy, p.dx);
      const float l = a.l_post[o];
      tab3[kRow * j + 1] = f_sub(p.x, f_mul(l, sinf(dir)));
      tab3[kRow * j + 5] = f_add(p.y, f_mul(l, cosf(dir)));
    }
    __syncthreads();
  }

  // 2. Refit: arc length, Thomas sweeps, coefficients.
  const long long nv3 = a.n_layers[b];
  const bool sorted3 = refit(tab3, M, nv3, h3);
  if (tid == 0) sh.e3 = make_ends(tab3, M, nv3, sorted3);
  __syncthreads();
  const Ends e3 = sh.e3;
  const float length3 = e3.s_hi;

  // 3. The target's grid pre-scan (splines.project), a first argmin.
  const float tx = a.target_x[b], ty = a.target_y[b];
  grid_prescan(tab3, e3, tx, ty, length3, red_v, red_i, &sh.best);

  // Init state, trim, and the resample recurrence: warp 0.
  if (warp == 0) {
    const float sx = a.start_x[b], sy = a.start_y[b];
    const float sh0 = a.start_heading[b];
    const Point p0 = eval_warp(tab3, e3, 0.f, lane);
    const float ih = atan2f(p0.dy, p0.dx);
    const float dx = f_sub(p0.x, sx), dy = f_sub(p0.y, sy);
    const float local_y = f_add(f_mul(-dx, sinf(sh0)), f_mul(dy, cosf(sh0)));
    const float min_dist = hypotf(dx, dy);
    const float err = constrain_angle(f_sub(sh0, ih));

    const Point pe = eval_warp(tab3, e3, length3, lane);
    const float eh = atan2f(pe.dy, pe.dx);
    const float local_tx = f_add(f_mul(f_sub(tx, pe.x), cosf(eh)),
                                 f_mul(f_sub(ty, pe.y), sinf(eh)));
    // splines.project_newton from the grid's winner.
    const float max_s =
        local_tx > 0.f ? length3
                       : newton_warp(tab3, e3, tx, ty, length3,
                                     static_cast<float>(sh.best),
                                     a.newton_iters, lane);

    if (a.dynamic) {
      float s_cur = 0.f;
      for (int k = 0; k < N; ++k) {
        if (lane == 0) ks[k] = s_cur;
        const float curv = curvature(eval_warp(tab3, e3, s_cur, lane));
        const float share =
            clip(f_mul(f_sub(fabsf(curv), kSmallK), a.inv_k_span), 0.f, 1.f);
        s_cur = f_sub(f_add(s_cur, a.ds), f_mul(share, a.ds_shrink));
      }
    }
    if (lane == 0) {
      sh.max_s = max_s;
      a.init[b] = local_y < 0.f ? min_dist : -min_dist;
      a.init[a.batch + b] = err;
      a.flags[2 * a.batch + b] = fabsf(err) <= a.init_limit;
    }
  }
  __syncthreads();

  // 4. The knots: s clamped to the trimmed length, n_valid, truncated.
  const float max_s = sh.max_s;
  long long nv_ref;
  {
    int count = 0;
    for (int k = tid; k < N; k += nt) {
      const float raw = a.dynamic ? ks[k] : f_mul(static_cast<float>(k), a.ds);
      count += raw <= max_s;
      if (k == N - 1) sh.truncated = raw < max_s;
      ks[k] = nanmin(raw, max_s);
    }
    if (a.dynamic && count) atomicAdd(&sh.count, count);
    __syncthreads();
    if (a.dynamic) {
      nv_ref = sh.count;
    } else {
      nv_ref = static_cast<long long>(floorf(f_mul(max_s, a.inv_ds))) + 1;
      nv_ref = nv_ref < N ? nv_ref : N;
    }
  }
  const int truncated = a.dynamic ? sh.truncated : a.full_s < max_s;

  // 5. States at the knots.
  const size_t BN = static_cast<size_t>(a.batch) * N;
  const size_t row = static_cast<size_t>(b) * N;
  for (int k = tid; k < N; k += nt) {
    const Point p = eval_thread(tab3, e3, ks[k]);
    const float h = atan2f(p.dy, p.dx);
    kx[k] = p.x;
    ky[k] = p.y;
    kh[k] = h;
    a.ref[row + k] = p.x;
    a.ref[BN + row + k] = p.y;
    a.ref[2 * BN + row + k] = h;
    a.ref[3 * BN + row + k] = curvature(p);
    a.ref[4 * BN + row + k] = ks[k];
  }
  __syncthreads();

  // Axle projections, clearances and bounds; the centre corridor.
  const int tasks = (a.with_center ? 3 : 2) * N;
  for (int t = tid; t < tasks; t += nt) {
    if (t >= 2 * N) {
      const int k = t - 2 * N;
      float left, right;
      clearance(a, kx[k], ky[k], kh[k], left, right);
      a.bnd[4 * BN + row + k] = right;
      a.bnd[5 * BN + row + k] = left;
      continue;
    }
    const int ax = t / N, k = t - ax * N;
    const float L = ax == 0 ? a.front_len : a.rear_len;
    const float h = kh[k], ch = cosf(h), shh = sinf(h);
    const float cx = f_add(kx[k], f_mul(L, ch));
    const float cy = f_add(ky[k], f_mul(L, shh));
    const float max_sk = f_add(ks[k], kProjReach);
    const float normal = f_add(h, kHalfPi);
    const float sa = sinf(normal), ca = cosf(normal);
    float proj = dir_newton(tab3, e3, cx, cy, sa, -ca, max_sk,
                            f_add(ks[k], L), a.newton_iters);
    if (a.prescan) {
      // splines.project_directional: the grid's first least |ray
      // distance|, Newton from it; whichever lands closer to the ray.
      const float start = nanmax(f_sub(ks[k], kProjReach), 0.f);
      float best_v = INFINITY, best_c = 0.f;
      int best_i = INT_MAX;
      for (int j = 0; j < kDirGrid; ++j) {
        float c = f_add(start, f_mul(static_cast<float>(j), kDirGridDs));
        const bool valid = c <= max_sk;
        c = nanmin(nanmax(c, 0.f), max_sk);
        const Point p = eval_thread(tab3, e3, c);
        const float ray = valid ? fabsf(f_sub(f_mul(sa, f_sub(p.x, cx)),
                                              f_mul(ca, f_sub(p.y, cy))))
                                : INFINITY;
        if (before(ray, j, best_v, best_i)) {
          best_v = ray;
          best_i = j;
          best_c = c;
        }
      }
      const float alt = dir_newton(tab3, e3, cx, cy, sa, -ca, max_sk, best_c,
                                   a.newton_iters);
      if (ray_residual(tab3, e3, cx, cy, sa, ca, alt) <
          ray_residual(tab3, e3, cx, cy, sa, ca, proj))
        proj = alt;
    }
    const Point p = eval_thread(tab3, e3, proj);
    float left, right;
    clearance(a, p.x, p.y, h, left, right);
    const float off =
        f_add(f_mul(-f_sub(p.x, cx), shh), f_mul(f_sub(p.y, cy), ch));
    const float ub = f_add(left, off), lb = f_add(right, off);
    a.bnd[(2 * ax) * BN + row + k] = lb;
    a.bnd[(2 * ax + 1) * BN + row + k] = ub;
    a.bnd[(6 + 2 * ax) * BN + row + k] = cx;
    a.bnd[(7 + 2 * ax) * BN + row + k] = cy;
    if (k < nv_ref && fabsf(f_sub(ub, lb)) < a.epsilon)
      atomicMin(&sh.first, k);
  }
  if (!a.with_center) {
    for (int k = tid; k < N; k += nt) {
      a.bnd[4 * BN + row + k] = 0.f;
      a.bnd[5 * BN + row + k] = 0.f;
    }
  }
  __syncthreads();

  // 6. The blocked truncation.
  if (tid == 0) {
    const bool blocked = sh.first < N;
    const long long first = sh.first;
    a.n_valid[b] = blocked && first < nv_ref ? first : nv_ref;
    a.flags[b] = truncated;
    a.flags[a.batch + b] = blocked;
  }
}

}  // namespace

// 0 if the arguments and plan are what the kernel takes, else
// cudaErrorInvalidValue.
int geometry_error(const GeoArgs& a, int threads, int smem_bytes) {
  if (a.batch < 1 || a.S < 2 || a.S > kGeoMaxSegmentPoints || a.M < 2 ||
      a.M > kGeoMaxLayers || a.N < 1 || a.N > kGeoMaxKnots ||
      a.n_rows < 2 || a.n_cols < 2 || a.c_pad < a.n_cols ||
      a.newton_iters < 0 || threads != geometry_threads(a.N) ||
      static_cast<size_t>(smem_bytes) != geometry_smem_bytes(a.S, a.M, a.N) ||
      smem_bytes > kMaxSmemBytes ||
      reinterpret_cast<uintptr_t>(a.quad) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). The plan comes from
// pipeline.geometry_plan: threads = geometry_threads(N), smem_bytes =
// geometry_smem_bytes(S, M, N); a plan, shape or map the kernel does not
// take (or a stencil table not 16-byte aligned) is refused with
// cudaErrorInvalidValue without running.
extern "C" int pathopt_geometry(const pathopt::GeoArgs* a, int threads,
                                int smem_bytes, void* stream) {
  const int err = pathopt::geometry_error(*a, threads, smem_bytes);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      pathopt::geometry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  pathopt::geometry_kernel<<<a->batch, threads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return pathopt::launch_status();
}
