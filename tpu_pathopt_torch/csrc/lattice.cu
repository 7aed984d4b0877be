// K6: the DP corridor search's lattice (corridor.prepare_lattice up to its
// edge costs, and the refit of the smoothed route before it), one CTA a
// scenario.
//
// Replaces: tpu_pathopt/corridor.py, _build_lattice_geom, prepare_lattice's
// feasibility and _rough_bounds, and tpu_pathopt/pipeline.py,
// _refit_splines. These are no Pallas kernels: the JAX package builds the
// lattice and refits the route as XLA code. The port issued the same work
// from the host as about 3,300 small PyTorch kernels (the refit's Thomas
// sweeps, about 8 kernels a knot; the projection's 12 Newton steps, each a
// whole paired spline evaluation; the layers' and nodes' evaluations), and
// in the compiled call their number, not their work, set the time: about
// 5 ms at B 256 as at B 1, 71% of the corridor stage at 35 laterals. This
// kernel runs all of it in one launch.
//
// For each scenario (every array batch-leading; the CTA's threads stride
// over the rows of each phase):
//  1. the route's spline: with `refit`, splines.refit of the smoothed
//     route's points (splines.cuh's refit: the arc length summed in float64,
//     the natural-BC Thomas sweeps of x and y, the coefficients), written
//     out as splines.fit_xy's fields, and the corridor's length, the arc
//     length's end plus `extend` (corridor.ROUTE_EXTENSION); without, the
//     spline and the length the caller gives;
//  2. the vehicle's projection (splines.project: 256 grid candidates, one a
//     thread, a first argmin over the CTA, then Newton in warp 0), the
//     layers' count and spacing, the vehicle's lateral offset, `ok` and
//     the start node's lateral index;
//  3. the L layers (one a thread): their s, the reference point, heading,
//     curvature and signed turn radius;
//  4. the L x K nodes (one a thread): the lateral offset, the node's
//     position along the layer's normal, its ESDF clearance (-1 outside the
//     map), the DP's feasibility rule (layer 0 only the start node), a bit a
//     node in shared memory;
//  5. the rough bounds (one node a thread): the lateral offset at the start
//     and at the end of the node's feasible run along K, found from the
//     bits (corridor._hold_from_run_start).
//
// Numerics: bit for bit the plain chain on the card, by the rules of
// splines.cuh. Besides them: the layer count's (length - s) / ds divides
// by a tensor (a correctly rounded division), the start index's
// (range + l) / spacing by a Python number (times 1 / spacing taken in
// double), 1.0 / k is PyTorch's reciprocal (a correctly rounded 1 / k,
// then times 1), and every comparison with a Python number compares with
// its float32 rounding.
//
// What bounds it on the H100: not bytes. A scenario reads its route (2 S
// floats, 9 S without the refit) and the ESDF's stencils at its L K nodes
// (L2; the 60 m map's 1.4 MB table is read once into it), and writes
// 6 L K + 11 S + 5 L values: about 2 us of HBM at B 256 and 35 laterals,
// 9 us at 135. The chain bounds it: the refit's forward and backward Thomas
// passes (2 S dependent steps, each a division), the float64 arc-length
// sum (S dependent adds), the grid pre-scan's argmin and `newton_iters`
// dependent Newton steps, each a segment search and a spline evaluation,
// then one dependent evaluation a layer and an ESDF read a node. At B
// <= about 500 every CTA is resident at once, so the launch takes about one
// scenario's chain at B 1 as at B 256.
//
// What the design does about it: the whole lattice is one CTA, so nothing
// between phases leaves the SM: the route's table, the refit's sweeps, the
// layers' frame and the feasibility bits sit in shared memory; the serial
// parts run on one thread (the sums), two threads (the x and y sweeps
// together) or one warp (Newton, with the segment search a ballot over 32
// knots at a time); everything else spreads over the CTA, whose node
// phase issues its ESDF reads independently so that their L2 latencies
// overlap, and the rough bounds need no scan along K: each node finds its
// run's ends in at most K / 32 words of bits. Launch plan
// (corridor.lattice_plan, checked here): threads = 32 ceil(L K / 256)
// within [256, 512] (the pre-scan's 256 candidates one a thread; about 8
// nodes a thread below 512); dynamic shared memory 4 (16 S + 6 L + L
// ceil(K / 32) + 64) bytes.
#include <cmath>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "splines.cuh"

namespace pathopt {

// The arguments, field for field kernels.LatticeArgs.
struct LatArgs {
  // The smoothed route: its points x, y (B, S) and valid points (B,) int64.
  const float* x;
  const float* y;
  const long long* n_valid;
  // Its spline on one knot vector (splines.fit_xy's fields): the knots
  // (B, S), a, b, c of x and of y (B, S - 1), and the corridor's length
  // (B,). Read where refit is 0; written where it is 1.
  float* s;
  float* xa;
  float* xb;
  float* xc;
  float* ya;
  float* yb;
  float* yc;
  float* length;
  // The vehicle's position (B,).
  const float* start_x;
  const float* start_y;
  // The map's packed bilinear stencils ((rows - 1) (c_pad - 1), 4).
  const float* quad;
  // Outputs: layers_s (B, L); n_layers (B,) int64; vehicle_l (B,); ok (B,)
  // bool; start_idx (B,) int64; lat (K,); ref (5, B, L): x, y, heading,
  // curvature, turn radius; node (5, B, L, K): x, y, clearance, rough lb,
  // rough ub; feasible (B, L, K) bool.
  float* layers_s;
  long long* n_layers;
  float* vehicle_l;
  unsigned char* ok;
  long long* start_idx;
  float* lat;
  float* ref;
  float* node;
  unsigned char* feasible;
  int batch;
  int S;
  int L;
  int K;
  int n_rows;
  int n_cols;
  int c_pad;
  int newton_iters;
  int refit;
  // Float32 roundings of the chain's Python numbers (the reciprocals taken
  // in double, as PyTorch takes them).
  float row_c;
  float col_c;
  float inv_res;
  float half_x;
  float half_y;
  float extend;
  float long_ds;
  float lat_ds;
  float inv_lat_ds;
  float lat_range;
  float threshold;
};

// The launch plan's limits (corridor.LAT_MAX_*, LAT_MIN_THREADS).
constexpr int kLatMaxSegmentPoints = 1024;
constexpr int kLatMaxLayers = 300;
constexpr int kLatMaxLaterals = 300;
constexpr int kLatMinThreads = 256;
constexpr int kLatMaxThreads = 512;

inline int lattice_threads(int L, int K) {
  const int t = (L * K + 255) / 256 * 32;
  return t < kLatMinThreads ? kLatMinThreads
                            : (t > kLatMaxThreads ? kLatMaxThreads : t);
}

inline size_t lattice_smem_bytes(int S, int L, int K) {
  return 4 * (16 * static_cast<size_t>(S) + 6 * static_cast<size_t>(L) +
              static_cast<size_t>(L) * ((K + 31) / 32) + 64);
}

namespace {

// Python doubles rounded to float32: the layer count's 1e-6, the layer
// spacing near the route's end, the turn radius's floor on |k|.
constexpr float kLayerEps = static_cast<float>(1e-6);
constexpr float kShortRoute = static_cast<float>(6.0);
constexpr float kShortDs = static_cast<float>(0.5);
constexpr float kRadiusFloor = static_cast<float>(1e-9);

// The first index of the run of set bits that holds bit k (k is set).
__device__ __forceinline__ int run_start(const unsigned* row, int k) {
  int w = k >> 5;
  unsigned clear = ~row[w] & ((1u << (k & 31)) - 1u);
  while (!clear) {
    if (--w < 0) return 0;
    clear = ~row[w];
  }
  return (w << 5) + 32 - __clz(clear);
}

// The last index below K of the run of set bits that holds bit k (k is
// set; no bit at K or past it is).
__device__ __forceinline__ int run_end(const unsigned* row, int k, int K) {
  const int words = (K + 31) >> 5;
  int w = k >> 5;
  unsigned clear = ~row[w] & ~((2u << (k & 31)) - 1u);
  while (!clear) {
    if (++w >= words) return K - 1;
    clear = ~row[w];
  }
  const int e = (w << 5) + __ffs(clear) - 1;
  return (e < K ? e : K) - 1;
}

// A scenario's scalars.
struct LatLane {
  Ends e;
  float length;
  float proj;       // the vehicle's projection
  float ds;         // the layer spacing
  long long n_layers;
  long long start_idx;
  int best;         // the pre-scan's winner
};

__global__ void __launch_bounds__(kLatMaxThreads)
    lattice_kernel(const LatArgs a) {
  extern __shared__ float smem[];
  __shared__ LatLane sh;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, L = a.L, K = a.K, W = (K + 31) >> 5;
  float* tab = smem;                   // S rows: the route's spline
  float* work = tab + kRow * S;        // the refit's sweeps, 7 S
  float* rx = work + 7 * S;            // the layers' point, heading's sine
  float* ry = rx + L;                  // and cosine, curvature, radius
  float* rsin = ry + L;
  float* rcos = rsin + L;
  float* rk = rcos + L;
  float* rr = rk + L;
  unsigned* bits = reinterpret_cast<unsigned*>(rr + L);  // L x W: feasible
  float* red_v = reinterpret_cast<float*>(bits + L * W);  // 32 + 32 words
  int* red_i = reinterpret_cast<int*>(red_v + 32);

  // 1. The route's spline, and whether its knots are non-decreasing.
  const size_t o = static_cast<size_t>(b) * S;
  const size_t oc = static_cast<size_t>(b) * (S - 1);
  const long long nv = a.n_valid[b];
  int unsorted = 0;
  for (int k = tid; k < S; k += nt) {
    float* r = tab + kRow * k;
    r[1] = a.x[o + k];
    r[5] = a.y[o + k];
    if (!a.refit) {
      const bool seg = k < S - 1;
      r[0] = a.s[o + k];
      r[2] = seg ? a.xa[oc + k] : 0.f;
      r[3] = seg ? a.xb[oc + k] : 0.f;
      r[4] = seg ? a.xc[oc + k] : 0.f;
      r[6] = seg ? a.ya[oc + k] : 0.f;
      r[7] = seg ? a.yb[oc + k] : 0.f;
      r[8] = seg ? a.yc[oc + k] : 0.f;
      if (seg) unsorted |= !(a.s[o + k] <= a.s[o + k + 1]);
    }
  }
  for (int w = tid; w < L * W; w += nt) bits[w] = 0u;
  unsorted = __syncthreads_or(unsorted);
  if (a.refit) {
    const bool sorted = refit(tab, S, nv, work);
    for (int k = tid; k < S; k += nt) {
      const float* r = tab + kRow * k;
      a.s[o + k] = r[0];
      if (k < S - 1) {
        a.xa[oc + k] = r[2];
        a.xb[oc + k] = r[3];
        a.xc[oc + k] = r[4];
        a.ya[oc + k] = r[6];
        a.yb[oc + k] = r[7];
        a.yc[oc + k] = r[8];
      }
    }
    if (tid == 0) {
      sh.e = make_ends(tab, S, nv, sorted);
      sh.length = f_add(sh.e.s_hi, a.extend);
      a.length[b] = sh.length;
    }
  } else if (tid == 0) {
    sh.e = make_ends(tab, S, nv, !unsorted);
    sh.length = a.length[b];
  }
  __syncthreads();
  const Ends e = sh.e;
  const float length = sh.length;

  // 2. The vehicle's projection, the layers' count, its lateral offset.
  const float sx = a.start_x[b], sy = a.start_y[b];
  grid_prescan(tab, e, sx, sy, length, red_v, red_i, &sh.best);
  if (warp == 0) {
    const float proj = newton_warp(tab, e, sx, sy, length,
                                   static_cast<float>(sh.best),
                                   a.newton_iters, lane);
    const float ds = length > kShortRoute ? a.long_ds : kShortDs;
    long long n_layers = static_cast<long long>(
        ceilf(f_sub(f_div(f_sub(length, proj), ds), kLayerEps))) + 1;
    n_layers = n_layers < 1 ? 1 : (n_layers > L ? L : n_layers);
    const Point p = eval_warp(tab, e, proj, lane);
    const float ph = atan2f(p.dy, p.dx);
    const float dx = f_sub(sx, p.x), dy = f_sub(sy, p.y);
    const float vl = f_add(f_mul(-dx, sinf(ph)), f_mul(dy, cosf(ph)));
    long long si = static_cast<int>(
        f_mul(f_add(vl, a.lat_range), a.inv_lat_ds));
    si = si < 0 ? 0 : (si > K - 1 ? K - 1 : si);
    if (lane == 0) {
      sh.proj = proj;
      sh.ds = ds;
      sh.n_layers = n_layers;
      sh.start_idx = si;
      a.n_layers[b] = n_layers;
      a.vehicle_l[b] = vl;
      a.ok[b] = fabsf(vl) <= a.lat_range;
      a.start_idx[b] = si;
    }
  }
  __syncthreads();

  // 3. The layers.
  const size_t BL = static_cast<size_t>(a.batch) * L;
  const size_t ol = static_cast<size_t>(b) * L;
  {
    const float proj = sh.proj, ds = sh.ds;
    const float last = static_cast<float>(sh.n_layers - 1);
    for (int j = tid; j < L; j += nt) {
      const float fj = static_cast<float>(j);
      const float ls = fj < last ? f_add(proj, f_mul(fj, ds)) : length;
      const Point p = eval_thread(tab, e, ls);
      const float h = atan2f(p.dy, p.dx);
      const float k = curvature(p);
      const float r = f_div(
          1.f, fabsf(k) < kRadiusFloor ? (k < 0.f ? -kRadiusFloor
                                                  : kRadiusFloor)
                                       : k);
      rx[j] = p.x;
      ry[j] = p.y;
      rsin[j] = sinf(h);
      rcos[j] = cosf(h);
      rk[j] = k;
      rr[j] = r;
      a.layers_s[ol + j] = ls;
      a.ref[ol + j] = p.x;
      a.ref[BL + ol + j] = p.y;
      a.ref[2 * BL + ol + j] = h;
      a.ref[3 * BL + ol + j] = k;
      a.ref[4 * BL + ol + j] = r;
    }
  }
  __syncthreads();

  // 4. The nodes, their clearance and feasibility.
  const size_t BLK = BL * K;
  const size_t on = ol * K;
  const long long si = sh.start_idx;
  for (int t = tid; t < L * K; t += nt) {
    const int j = t / K, k = t - j * K;
    const float l = f_add(f_mul(a.lat_ds, static_cast<float>(k)), -a.lat_range);
    const float nx = f_sub(rx[j], f_mul(l, rsin[j]));
    const float ny = f_add(ry[j], f_mul(l, rcos[j]));
    const bool inside = fabsf(nx) <= a.half_x && fabsf(ny) <= a.half_y;
    const float dis = inside ? esdf(a, nx, ny) : -1.f;
    bool feas;
    if (j == 0) {
      feas = k == si;
    } else {
      const float kj = rk[j], rj = rr[j];
      const bool radius_bad = (kj < 0.f && l < rj) || (kj > 0.f && l > rj);
      feas = !(radius_bad || dis < a.threshold) && l <= a.lat_range;
    }
    a.node[on + t] = nx;
    a.node[BLK + on + t] = ny;
    a.node[2 * BLK + on + t] = dis;
    a.feasible[on + t] = feas;
    if (feas) atomicOr(bits + j * W + (k >> 5), 1u << (k & 31));
    if (b == 0 && j == 0) a.lat[k] = l;
  }
  __syncthreads();

  // 5. The rough bounds: the lateral offsets at the ends of each node's
  // feasible run (the node's own where it is not feasible).
  for (int t = tid; t < L * K; t += nt) {
    const int j = t / K, k = t - j * K;
    const unsigned* row = bits + j * W;
    int lo = k, hi = k;
    if (row[k >> 5] >> (k & 31) & 1u) {
      lo = run_start(row, k);
      hi = run_end(row, k, K);
    }
    a.node[3 * BLK + on + t] =
        f_add(f_mul(a.lat_ds, static_cast<float>(lo)), -a.lat_range);
    a.node[4 * BLK + on + t] =
        f_add(f_mul(a.lat_ds, static_cast<float>(hi)), -a.lat_range);
  }
}

}  // namespace

// 0 if the arguments and plan are what the kernel takes, else
// cudaErrorInvalidValue.
int lattice_error(const LatArgs& a, int threads, int smem_bytes) {
  if (a.batch < 1 || a.S < 2 || a.S > kLatMaxSegmentPoints || a.L < 2 ||
      a.L > kLatMaxLayers || a.K < 1 || a.K > kLatMaxLaterals ||
      a.n_rows < 2 || a.n_cols < 2 || a.c_pad < a.n_cols ||
      a.newton_iters < 0 || (a.refit != 0 && a.refit != 1) ||
      threads != lattice_threads(a.L, a.K) ||
      static_cast<size_t>(smem_bytes) != lattice_smem_bytes(a.S, a.L, a.K) ||
      smem_bytes > kMaxSmemBytes ||
      reinterpret_cast<uintptr_t>(a.quad) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace pathopt

// Returns the cudaError_t of the launch (0 on success). The plan comes from
// corridor.lattice_plan: threads = lattice_threads(L, K), smem_bytes =
// lattice_smem_bytes(S, L, K); a plan, shape or map the kernel does not
// take (or a stencil table not 16-byte aligned) is refused with
// cudaErrorInvalidValue without running.
extern "C" int pathopt_lattice(const pathopt::LatArgs* a, int threads,
                               int smem_bytes, void* stream) {
  const int err = pathopt::lattice_error(*a, threads, smem_bytes);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      pathopt::lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  pathopt::lattice_kernel<<<a->batch, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return pathopt::launch_status();
}
