// Device functions K5 (geometry.cu), K6 (lattice.cu) and K7 (prep.cu)
// share: the natural cubic spline of a route as a table in shared memory,
// its evaluation (splines.evaluate, eval_xy_fused), its fit on given knots
// (splines.fit_xy) and its refit from a polyline (splines.refit), the
// closest-point projection (splines.project: the grid pre-scan, then
// Newton) and the ESDF's bilinear read (maps.obstacle_distance).
//
// Numerics: bit for bit the plain chain on the card. Every float32
// operation is one correctly rounded operation in the chain's order (the
// _rn intrinsics keep nvcc from contracting adds and multiplies into FMAs),
// atan2f, sinf, cosf, hypotf and powf are the precise libdevice functions
// PyTorch's CUDA kernels call, a division by a Python number d is PyTorch's
// multiply by 1 / d taken in double and rounded to float32, x ** 2 is x * x,
// x ** 1.5 powf, torch.clamp, minimum and maximum keep NaN, and each argmin
// keeps the first NaN, else the first least value, as torch.argmin does. A
// segment search returns the count of knots <= q, as
// splines._segment_index: a binary search where the knots are
// non-decreasing (checked), a linear count where they are not (NaN), a
// ballot count in a warp.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace pathopt {
namespace {

// Python doubles rounded to float32, as PyTorch rounds a scalar operand:
// splines.py's Hessian guard, the refit's segment floor, x / 6.0 and x / 2.0
// (x times the reciprocal on the card).
constexpr float kHessFloor = static_cast<float>(1e-12);
constexpr float kSegFloor = static_cast<float>(1e-6);
constexpr float kInvSix = static_cast<float>(1.0 / 6.0);
constexpr float kHalf = static_cast<float>(1.0 / 2.0);
// splines.project's grid: candidates from 0, 1 m apart.
constexpr int kProjGrid = 256;
// A spline table's row: s, x, xa, xb, xc, y, ya, yb, yc (a, b, c of the
// segment starting at s; the last row's are 0 and never read).
constexpr int kRow = 9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float f_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float f_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float f_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float f_div(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.minimum / clamp(max=): NaN if either is NaN.
__device__ __forceinline__ float nanmin(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// splines._guard.
__device__ __forceinline__ float guard(float h) {
  return fabsf(h) < kHessFloor ? kHessFloor : h;
}

// torch.argmin's order: a NaN before any number, else the smaller value;
// ties to the lower index. A total order, so any reduction order gives the
// same winner.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (a != a) return b != b ? ia < ib : true;
  if (b != b) return false;
  return a == b ? ia < ib : a < b;
}

// torchutil.take's index: i mod n with Python's sign, at most n - 1.
__device__ __forceinline__ int take_index(long long i, int n) {
  long long r = i % n;
  if (r < 0) r += n;
  return static_cast<int>(r < n - 1 ? r : n - 1);
}

// What splines.evaluate reads of a spline beside the segment's row.
struct Ends {
  float s_lo, s_hi;
  float x_lo, x_lo_slope, x_hi, x_hi_slope;
  float y_lo, y_lo_slope, y_hi, y_hi_slope;
  long long seg_max;  // n_valid - 2, the last segment a query may take
  int knots;
  int sorted;         // knots non-decreasing: a binary search counts them
};

struct Point {
  float x, y, dx, dy, ddx, ddy;
};

// splines._end_slope of the curve whose values sit in column `col`.
__device__ float end_slope(const float* tab, int knots, long long nv,
                           int col) {
  const float h = f_sub(tab[kRow * take_index(nv - 1, knots)],
                        tab[kRow * take_index(nv - 2, knots)]);
  const float* r = tab + kRow * take_index(nv - 2, knots - 1) + col;
  return f_add(f_add(r[3], f_mul(f_mul(2.f, r[2]), h)),
               f_mul(f_mul(3.f, r[1]), f_mul(h, h)));
}

__device__ Ends make_ends(const float* tab, int knots, long long nv,
                          int sorted) {
  const int hi = take_index(nv - 1, knots);
  Ends e;
  e.s_lo = tab[0];
  e.s_hi = tab[kRow * hi];
  e.x_lo = tab[1];
  e.x_lo_slope = tab[4];
  e.x_hi = tab[kRow * hi + 1];
  e.x_hi_slope = end_slope(tab, knots, nv, 1);
  e.y_lo = tab[5];
  e.y_lo_slope = tab[8];
  e.y_hi = tab[kRow * hi + 5];
  e.y_hi_slope = end_slope(tab, knots, nv, 5);
  e.seg_max = nv - 2;
  e.knots = knots;
  e.sorted = sorted;
  return e;
}

// One curve of splines.evaluate (orders 0, 1, 2) on the segment row r
// (value, a, b, c), with the linear extrapolation outside [s_lo, s_hi].
__device__ __forceinline__ void cubic(const float* r, float t, bool below,
                                      bool above, float dq_lo, float dq_hi,
                                      float lo, float lo_slope, float hi,
                                      float hi_slope, float& v, float& d1,
                                      float& d2) {
  const float a = r[1], b = r[2], c = r[3];
  v = f_add(r[0], f_mul(t, f_add(c, f_mul(t, f_add(b, f_mul(t, a))))));
  const float b2 = f_mul(2.f, b);
  d1 = f_add(c, f_mul(t, f_add(b2, f_mul(f_mul(3.f, a), t))));
  d2 = f_add(b2, f_mul(f_mul(6.f, a), t));
  if (below) {
    v = f_add(lo, f_mul(lo_slope, dq_lo));
    d1 = lo_slope;
    d2 = 0.f;
  } else if (above) {
    v = f_add(hi, f_mul(hi_slope, dq_hi));
    d1 = hi_slope;
    d2 = 0.f;
  }
}

// Both curves at q, given the count of knots <= q.
__device__ Point eval_count(const float* tab, const Ends& e, float q,
                            int count) {
  long long i = count - 1;
  i = i < 0 ? 0 : i;
  i = i < e.seg_max ? i : e.seg_max;
  i = i < 0 ? 0 : i;
  const float* r = tab + kRow * i;
  const float t = f_sub(q, r[0]);
  const bool below = q < e.s_lo, above = q > e.s_hi;
  const float dq_lo = f_sub(q, e.s_lo), dq_hi = f_sub(q, e.s_hi);
  Point p;
  cubic(r + 1, t, below, above, dq_lo, dq_hi, e.x_lo, e.x_lo_slope, e.x_hi,
        e.x_hi_slope, p.x, p.dx, p.ddx);
  cubic(r + 5, t, below, above, dq_lo, dq_hi, e.y_lo, e.y_lo_slope, e.y_hi,
        e.y_hi_slope, p.y, p.dy, p.ddy);
  return p;
}

// One thread's evaluation.
__device__ Point eval_thread(const float* tab, const Ends& e, float q) {
  int n = 0;
  if (e.sorted) {
    int hi = e.knots;
    while (n < hi) {
      const int mid = (n + hi) >> 1;
      if (tab[kRow * mid] <= q)
        n = mid + 1;
      else
        hi = mid;
    }
  } else {
    for (int k = 0; k < e.knots; ++k) n += tab[kRow * k] <= q;
  }
  return eval_count(tab, e, q, n);
}

// The same, by a whole warp at one q (every lane gets the result).
__device__ Point eval_warp(const float* tab, const Ends& e, float q,
                           int lane) {
  int n = 0;
  for (int base = 0; base < e.knots; base += 32) {
    const int k = base + lane;
    n += __popc(__ballot_sync(kFull, k < e.knots && tab[kRow * k] <= q));
  }
  return eval_count(tab, e, q, n);
}

// splines.curvature from a point's derivatives.
__device__ __forceinline__ float curvature(const Point& p) {
  return f_div(f_sub(f_mul(p.dx, p.ddy), f_mul(p.dy, p.ddx)),
               powf(f_add(f_mul(p.dx, p.dx), f_mul(p.dy, p.dy)), 1.5f));
}

// maps.obstacle_distance: the ESDF's bilinear value, 0 outside the map.
// `Map` has the map's packed stencils `quad` (16-byte aligned), its
// `n_rows`, `n_cols`, `c_pad`, and the float32 roundings `row_c`, `col_c`
// (0.5 n - 0.5), `inv_res` (1 / resolution in double), `half_x`, `half_y`.
template <class Map>
__device__ __forceinline__ float esdf(const Map& a, float x, float y) {
  const float fi = f_sub(a.row_c, f_mul(x, a.inv_res));
  const float fj = f_sub(a.col_c, f_mul(y, a.inv_res));
  long long i0 = static_cast<long long>(floorf(fi));
  long long j0 = static_cast<long long>(floorf(fj));
  i0 = i0 < 0 ? 0 : (i0 > a.n_rows - 2 ? a.n_rows - 2 : i0);
  j0 = j0 < 0 ? 0 : (j0 > a.n_cols - 2 ? a.n_cols - 2 : j0);
  const float ti = clip(f_sub(fi, static_cast<float>(i0)), 0.f, 1.f);
  const float tj = clip(f_sub(fj, static_cast<float>(j0)), 0.f, 1.f);
  const float4 v = __ldg(reinterpret_cast<const float4*>(a.quad) +
                         (i0 * (a.c_pad - 1) + j0));
  const float ui = f_sub(1.f, ti), uj = f_sub(1.f, tj);
  const float interp =
      f_add(f_add(f_add(f_mul(v.x, f_mul(ui, uj)), f_mul(v.y, f_mul(ui, tj))),
                  f_mul(v.z, f_mul(ti, uj))),
            f_mul(v.w, f_mul(ti, tj)));
  return (fabsf(x) <= a.half_x && fabsf(y) <= a.half_y) ? interp : 0.f;
}

// A first argmin over the CTA of each thread's (value, index); every
// thread gets the index.
__device__ int block_argmin(float v, int i, float* red_v, int* red_i,
                            int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(kFull, v, o);
    const int i2 = __shfl_down_sync(kFull, i, o);
    if (before(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    v = lane < warps ? red_v[lane] : INFINITY;
    i = lane < warps ? red_i[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_down_sync(kFull, v, o);
      const int i2 = __shfl_down_sync(kFull, i, o);
      if (before(v2, i2, v, i)) {
        v = v2;
        i = i2;
      }
    }
    if (lane == 0) *out = i;
  }
  __syncthreads();
  return *out;
}

// The knots of column 0 from the n - 1 segments h (float32; the CTA's
// threads have written them and passed a barrier): 0, then their running
// sum taken in float64 in index order and each rounded once to float32, as
// torch.cumsum(seg, -1, dtype=torch.float64).to(torch.float32) (thread 0;
// the caller waits at a barrier before reading them).
//
// The float64 sum is exact, so its order (the GPU's scan) does not matter
// where every segment is 0 or at least 1e-6 (above 2^-20, so a multiple of
// 2^-43) and the total below 1024 m (2^10), which 53 bits hold. Past that
// the sums round and a knot may differ from the plain cumsum's by one
// float32 ulp.
__device__ void arc_length(float* tab, int n, const float* h) {
  if (threadIdx.x == 0) {
    double sum = 0.0;
    tab[0] = 0.f;
    for (int j = 0; j < n - 1; ++j) {
      sum = __dadd_rn(sum, static_cast<double>(h[j]));
      tab[kRow * (j + 1)] = __double2float_rn(sum);
    }
  }
}

// splines.fit_xy of the curves in columns 1 (x) and 5 (y) of the table's n
// rows on the knots of column 0, nv of them valid (the CTA's threads have
// written them and passed a barrier): the knot intervals and slopes, the
// natural-BC Thomas sweep of x and y (splines.fit_natural,
// splines._thomas: threads 0 and 1), the cubic coefficients (one segment a
// thread). `work` holds 7 n floats. Every thread of the CTA calls it; on
// return the table is complete for all of them. Returns whether the knots
// are non-decreasing.
__device__ bool fit_knots(float* tab, int n, long long nv, float* work) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* h = work;       // knot intervals
  float* slx = h + n;    // slopes of x and y
  float* sly = slx + n;
  float* cpx = sly + n;  // Thomas: c', d' (then sigma)
  float* dpx = cpx + n;
  float* cpy = dpx + n;
  float* dpy = cpy + n;
  int unsorted = 0;
  for (int k = tid; k < n - 1; k += nt) {
    const float* r = tab + kRow * k;
    const float hk = f_sub(r[kRow], r[0]);
    h[k] = hk;
    slx[k] = f_div(f_sub(r[kRow + 1], r[1]), hk);
    sly[k] = f_div(f_sub(r[kRow + 5], r[5]), hk);
    unsorted |= !(r[0] <= r[kRow]);
  }
  unsorted = __syncthreads_or(unsorted);
  if (tid < 2) {
    // splines.fit_natural's system and splines._thomas: x on lane 0, y on
    // lane 1 (the same branches, so the two run together).
    const float* sl = tid == 0 ? slx : sly;
    float* cp = tid == 0 ? cpx : cpy;
    float* dp = tid == 0 ? dpx : dpy;
    float c_prev = 0.f, d_prev = 0.f;
    for (int i = 0; i < n; ++i) {
      const bool interior = i >= 1 && i <= nv - 2;
      const int im1 = i == 0 ? 0 : i - 1;
      const int ii = i < n - 1 ? i : n - 2;
      const float diag = interior ? f_mul(2.f, f_add(h[im1], h[ii])) : 1.f;
      const float lower = interior ? h[im1] : 0.f;
      const float upper = interior ? h[ii] : 0.f;
      const float rhs = interior ? f_mul(6.f, f_sub(sl[ii], sl[im1])) : 0.f;
      if (i == 0) {
        c_prev = f_div(upper, diag);
        d_prev = f_div(rhs, diag);
      } else {
        const float t = f_sub(diag, f_mul(lower, c_prev));
        c_prev = f_div(upper, t);
        d_prev = f_div(f_sub(rhs, f_mul(lower, d_prev)), t);
      }
      cp[i] = c_prev;
      dp[i] = d_prev;
    }
    // Back substitution; sigma (0 off the interior) replaces d'.
    float x = d_prev;
    dp[n - 1] = (n - 1 <= nv - 2) ? x : 0.f;
    for (int i = n - 2; i >= 0; --i) {
      x = f_sub(dp[i], f_mul(cp[i], x));
      dp[i] = (i >= 1 && i <= nv - 2) ? x : 0.f;
    }
  }
  __syncthreads();
  for (int k = tid; k < n; k += nt) {
    float* r = tab + kRow * k;
    if (k == n - 1) {
      r[2] = r[3] = r[4] = r[6] = r[7] = r[8] = 0.f;
      continue;
    }
    const float hk = h[k];
    const float six_h = f_mul(6.f, hk);
#pragma unroll
    for (int curve = 0; curve < 2; ++curve) {
      const float* sig = curve == 0 ? dpx : dpy;
      const float* sl = curve == 0 ? slx : sly;
      const float s0 = sig[k], s1 = sig[k + 1];
      float* c = r + 2 + 4 * curve;
      c[0] = f_div(f_sub(s1, s0), six_h);
      c[1] = f_mul(s0, kHalf);
      c[2] = f_sub(sl[k], f_mul(f_mul(hk, f_add(f_mul(2.f, s0), s1)), kInvSix));
    }
  }
  __syncthreads();
  return !unsorted;
}

// splines.refit of the polyline in columns 1 (x) and 5 (y) of the table's
// n rows, nv of them valid (the CTA's threads have written them and passed
// a barrier): the segments (at least 1e-6, 1 past the valid points), their
// arc length into column 0 (arc_length), then fit_knots. `work` holds 7 n
// floats. Every thread of the CTA calls it. Returns whether the knots are
// non-decreasing.
__device__ bool refit(float* tab, int n, long long nv, float* work) {
  for (int j = threadIdx.x; j < n - 1; j += blockDim.x) {
    const float* r = tab + kRow * j;
    const float seg =
        hypotf(f_sub(r[kRow + 1], r[1]), f_sub(r[kRow + 5], r[5]));
    work[j] = j <= nv - 2 ? nanmax(seg, kSegFloor) : 1.f;
  }
  __syncthreads();
  arc_length(tab, n, work);
  __syncthreads();
  return fit_knots(tab, n, nv, work);
}

// splines.project's grid pre-scan for (tx, ty): the first least squared
// distance over the kProjGrid candidates 0, 1, 2, ... m (those past max_s
// infinitely far), one a thread, a first argmin over the CTA. Every thread
// of the CTA calls it and gets the winner's index.
__device__ int grid_prescan(const float* tab, const Ends& e, float tx,
                            float ty, float max_s, float* red_v, int* red_i,
                            int* out) {
  float best_v = INFINITY;
  int best_i = INT_MAX;
  for (int k = threadIdx.x; k < kProjGrid; k += blockDim.x) {
    const float c = static_cast<float>(k);
    const Point p = eval_thread(tab, e, c);
    const float dx = f_sub(p.x, tx), dy = f_sub(p.y, ty);
    const float d2 =
        c <= max_s ? f_add(f_mul(dx, dx), f_mul(dy, dy)) : INFINITY;
    if (before(d2, k, best_v, best_i)) {
      best_v = d2;
      best_i = k;
    }
  }
  return block_argmin(best_v, best_i, red_v, red_i, out);
}

// splines.project_newton of (tx, ty) from `hint`, by a whole warp (every
// lane gets the result): min(s, max_s).
__device__ float newton_warp(const float* tab, const Ends& e, float tx,
                             float ty, float max_s, float hint, int iters,
                             int lane) {
  float cur = nanmin(hint, max_s);
  for (int it = 0; it < iters; ++it) {
    const Point p = eval_warp(tab, e, cur, lane);
    const float ex = f_sub(p.x, tx), ey = f_sub(p.y, ty);
    const float jcb = f_add(f_mul(ex, p.dx), f_mul(ey, p.dy));
    const float hes =
        f_add(f_add(f_add(f_mul(p.dx, p.dx), f_mul(ex, p.ddx)),
                    f_mul(p.dy, p.dy)),
              f_mul(ey, p.ddy));
    cur = f_sub(cur, f_div(jcb, guard(hes)));
  }
  return nanmin(cur, max_s);
}

}  // namespace
}  // namespace pathopt
