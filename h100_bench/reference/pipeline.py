"""The plain reference of the whole planning chain, in float64 NumPy and
SciPy, with dynamic shapes and data-dependent loops, the way the planner's
C++ reference computes it (path_optimizer_2; file:line cites inline).

B-spline fit -> 1 m segmentation -> TENSION2 smoothing QP -> DP corridor
search -> post-smoothing QP -> init/trim -> resampling (with dynamic
segmentation) -> ESDF collision bounds -> two-pass path QP -> SlState path.

Every QP is solved by :mod:`h100_bench.reference.qp` (OSQP in float64).
Splines are SciPy natural cubic splines with tk::spline's linear
extrapolation; the ESDF is SciPy's exact EDT of the occupancy mask. It
imports nothing of the program under test: it works everything out again
from the mask, the route and the start and target states.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import ndimage
from scipy.interpolate import BSpline, CubicSpline

from h100_bench.reference import qp as qp_oracle
from h100_bench.reference.config import PlannerConfig


def keep(a):
    """The identity: values pass between stages in float64."""
    return a


INFTY = 1e20
_INF = 1e30


# ------------------------------- map / ESDF ---------------------------------

@dataclasses.dataclass
class OracleMap:
    esdf: np.ndarray       # (R, C) meters
    resolution: float

    @property
    def half_extent(self):
        r, c = self.esdf.shape
        return 0.5 * r * self.resolution, 0.5 * c * self.resolution


def build_map(obstacle_mask, resolution=0.2) -> OracleMap:
    """cv::distanceTransform equivalent (demo.cpp:109-113): exact EDT of the
    free space, scaled to meters."""
    esdf = ndimage.distance_transform_edt(~np.asarray(obstacle_mask, bool))
    return OracleMap(esdf=esdf * resolution, resolution=resolution)


def is_inside(m: OracleMap, x, y):
    hx, hy = m.half_extent
    return (np.abs(x) <= hx) & (np.abs(y) <= hy)


def obstacle_distance(m: OracleMap, x, y):
    """Bilinear ESDF lookup, 0 outside (Map.cpp:16-22); grid_map convention:
    row 0 <-> max x, col 0 <-> max y, centered at origin."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    r, c = m.esdf.shape
    fi = (0.5 * r - 0.5) - x / m.resolution
    fj = (0.5 * c - 0.5) - y / m.resolution
    i0 = np.clip(np.floor(fi).astype(int), 0, r - 2)
    j0 = np.clip(np.floor(fj).astype(int), 0, c - 2)
    ti = np.clip(fi - i0, 0.0, 1.0)
    tj = np.clip(fj - j0, 0.0, 1.0)
    e = m.esdf
    v = (e[i0, j0] * (1 - ti) * (1 - tj) + e[i0, j0 + 1] * (1 - ti) * tj
         + e[i0 + 1, j0] * ti * (1 - tj) + e[i0 + 1, j0 + 1] * ti * tj)
    return np.where(is_inside(m, x, y), v, 0.0)


# ------------------------------ geometry ------------------------------------

def constrain_angle(a):
    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


def global_to_local(ref_x, ref_y, ref_h, x, y):
    dx, dy = x - ref_x, y - ref_y
    ch, sh = np.cos(ref_h), np.sin(ref_h)
    return dx * ch + dy * sh, -dx * sh + dy * ch


def normal_offset(x, y, heading, l):
    return x - l * np.sin(heading), y + l * np.cos(heading)


# ------------------------------- splines ------------------------------------

class NatSpline:
    """Natural cubic spline with tk::spline linear extrapolation
    (spline.cpp:251-299)."""

    def __init__(self, s, y):
        s = np.asarray(s, np.float64)
        y = np.asarray(y, np.float64)
        self.s_lo = s[0]
        self.s_hi = s[-1]
        self.cs = CubicSpline(s, y, bc_type="natural")
        self.lo_val = y[0]
        self.hi_val = y[-1]
        self.lo_slope = float(self.cs(s[0], 1))
        self.hi_slope = float(self.cs(s[-1], 1))

    def __call__(self, q, order=0):
        q = np.asarray(q, np.float64)
        below = q < self.s_lo
        above = q > self.s_hi
        qc = np.clip(q, self.s_lo, self.s_hi)
        if order == 0:
            val = self.cs(qc)
            val = np.where(below, self.lo_val + self.lo_slope * (q - self.s_lo),
                           val)
            val = np.where(above, self.hi_val + self.hi_slope * (q - self.s_hi),
                           val)
            return val
        if order == 1:
            val = self.cs(qc, 1)
            return np.where(below, self.lo_slope,
                            np.where(above, self.hi_slope, val))
        if order == 2:
            return np.where(below | above, 0.0, self.cs(qc, 2))
        raise ValueError(order)


def heading_of(xs: NatSpline, ys: NatSpline, q):
    return np.arctan2(ys(q, 1), xs(q, 1))


def curvature_of(xs: NatSpline, ys: NatSpline, q):
    dx, dy = xs(q, 1), ys(q, 1)
    ddx, ddy = xs(q, 2), ys(q, 2)
    return (dx * ddy - dy * ddx) / (dx * dx + dy * dy) ** 1.5


def refit_xy(x, y):
    """Cumulative-arc-length natural-spline refit (the reference's recurring
    set_points pattern). Returns (xs, ys, s_max)."""
    seg = np.hypot(np.diff(x), np.diff(y))
    seg = np.maximum(seg, 1e-6)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    return NatSpline(s, x), NatSpline(s, y), s[-1]


def project_newton(xs, ys, tx, ty, max_s, hint, iters=20):
    """Closest-point Newton projection (tools.cpp:98-126)."""
    cur = min(hint, max_s)
    for _ in range(iters):
        x, y = float(xs(cur)), float(ys(cur))
        dx, dy = float(xs(cur, 1)), float(ys(cur, 1))
        ddx, ddy = float(xs(cur, 2)), float(ys(cur, 2))
        jcb = (x - tx) * dx + (y - ty) * dy
        hes = dx * dx + (x - tx) * ddx + dy * dy + (y - ty) * ddy
        if abs(hes) < 1e-12:
            hes = 1e-12
        cur = cur - jcb / hes
    return min(cur, max_s)


def project(xs, ys, tx, ty, max_s, grid=1.0, max_grid_points=256):
    """Grid pre-scan + Newton (tools.cpp:66-96; splines.project semantics)."""
    cand = grid * np.arange(max_grid_points)
    valid = cand <= max_s
    d2 = (xs(cand) - tx) ** 2 + (ys(cand) - ty) ** 2
    d2 = np.where(valid, d2, np.inf)
    best = cand[np.argmin(d2)]
    return project_newton(xs, ys, tx, ty, max_s, best)


def project_directional_newton(xs, ys, tx, ty, angle, max_s, hint, iters):
    """Directional Newton projection (tools.cpp:156-189)."""
    v1, v2 = math.sin(angle), -math.cos(angle)
    cur = min(hint, max_s)
    for _ in range(iters):
        x, y = float(xs(cur)), float(ys(cur))
        dx, dy = float(xs(cur, 1)), float(ys(cur, 1))
        ddx, ddy = float(xs(cur, 2)), float(ys(cur, 2))
        p1 = v1 * (x - tx) + v2 * (y - ty)
        p2 = v1 * dx + v2 * dy
        jcb = p1 * p2
        hes = p1 * (v1 * ddx + v2 * ddy) + p2 * p2
        if abs(hes) < 1e-12:
            hes = 1e-12
        cur = cur - jcb / hes
    return min(cur, max_s)


# --------------------------- stage 1: B-spline fit ---------------------------

def bspline_fit_and_sample(raw_x, raw_y):
    """bSpline() (reference_path_smoother.cpp:490-524): raw points as control
    points of a clamped uniform B-spline, degree 3/4/5 by average spacing,
    sampled at dt = 1/length plus t = 1."""
    raw_x = np.asarray(raw_x, np.float64)
    raw_y = np.asarray(raw_y, np.float64)
    n = len(raw_x)
    length = float(np.hypot(np.diff(raw_x), np.diff(raw_y)).sum())
    avg = length / max(n - 1, 1)
    degree = 3 if avg > 10.0 else (4 if avg > 5.0 else 5)

    # Clamped uniform knot vector on [0, 1].
    n_inner = n - degree - 1
    knots = np.concatenate([np.zeros(degree + 1),
                            (np.arange(1, n_inner + 1) / (n - degree)),
                            np.ones(degree + 1)])
    spx = BSpline(knots, raw_x, degree)
    spy = BSpline(knots, raw_y, degree)

    n_interior = int(np.ceil(length))
    t = np.concatenate([np.arange(n_interior) / max(length, 1.0), [1.0]])
    xb, yb = spx(t), spy(t)
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xb), np.diff(yb)))])
    return xb, yb, s


# ------------------------ stage 2: 1 m segmentation --------------------------

def segment_raw_reference(xb, yb, sb, n_max):
    """segmentRawReference (reference_path_smoother.cpp:47-85): natural-spline
    fit over arc length, resample at 1 m up to ceil(max_s) (one step past)."""
    xs = NatSpline(sb, xb)
    ys = NatSpline(sb, yb)
    max_s = sb[-1]
    n_valid = min(int(np.ceil(max_s)) + 1, n_max)
    s = np.arange(n_valid, dtype=np.float64)
    return (xs(s), ys(s), s, heading_of(xs, ys, s), curvature_of(xs, ys, s),
            n_valid)


# ------------------------ stage 3: TENSION2 smoothing ------------------------

def tension2_smooth(x_in, y_in, angle_in, k_in, s_in, cfg: PlannerConfig,
                    eps=None):
    """TENSION2 QP (tension_smoother_2.cpp:20-158), dense float64, unpadded."""
    M = len(x_in)
    w_dev = cfg.tension_2_deviation_weight
    w_k = cfg.tension_2_curvature_weight
    w_kr = cfg.tension_2_curvature_rate_weight
    nv = 4 * M - 1
    nc = 3 * (M - 1) + 2
    xi, yi, ti, ki = 0, M, 2 * M, 3 * M

    P = np.zeros((nv, nv))
    for i in range(M):
        P[xi + i, xi + i] = 2.0 * w_dev
        P[yi + i, yi + i] = 2.0 * w_dev
    for i in range(M - 1):
        P[ki + i, ki + i] += 2.0 * w_k
    for i in range(M - 2):
        P[ki + i, ki + i] += 2.0 * w_kr
        P[ki + i + 1, ki + i + 1] += 2.0 * w_kr
        P[ki + i, ki + i + 1] -= 2.0 * w_kr
        P[ki + i + 1, ki + i] -= 2.0 * w_kr

    q = np.zeros(nv)
    q[xi:xi + M] = -2.0 * w_dev * x_in
    q[yi:yi + M] = -2.0 * w_dev * y_in

    A = np.zeros((nc, nv))
    b = np.zeros(nc)
    ds = np.diff(s_in)
    ds = np.where(ds > 1e-6, ds, 1.0)
    for i in range(M - 1):
        A[i, xi + i + 1] = 1.0
        A[i, xi + i] = -1.0
        A[i, ti + i] = ds[i] * np.sin(angle_in[i])
        b[i] = ds[i] * np.cos(angle_in[i])
        r = (M - 1) + i
        A[r, yi + i + 1] = 1.0
        A[r, yi + i] = -1.0
        A[r, ti + i] = -ds[i] * np.cos(angle_in[i])
        b[r] = ds[i] * np.sin(angle_in[i])
        r = 2 * (M - 1) + i
        A[r, ti + i + 1] = 1.0
        A[r, ti + i] = -1.0
        A[r, ki + i] = -ds[i]
        b[r] = -ds[i] * k_in[i]
    A[nc - 2, xi] = 1.0
    b[nc - 2] = x_in[0]
    A[nc - 1, yi] = 1.0
    b[nc - 1] = y_in[0]

    kw = _qp_kwargs(cfg, eps)
    sol = qp_oracle.solve(P, q, A, b, b, **kw)
    return sol.x[:M], sol.x[M:2 * M], sol.status == "solved"


def _qp_kwargs(cfg: PlannerConfig, eps=None):
    e = cfg.qp_eps_abs if eps is None else eps
    return dict(eps_abs=e, eps_rel=e, max_iter=cfg.qp_max_iter,
                check_every=cfg.qp_check_every)


# ------------------------ stage 4: DP corridor search ------------------------

def search_corridor(m: OracleMap, xs, ys, length, start_x, start_y,
                    start_heading, cfg: PlannerConfig):
    """graphSearchDp (reference_path_smoother.cpp:142-295), scalar float64.
    Mirrors corridor.search_corridor including the static caps (dp_layers,
    dp_laterals) so parity covers the fixed-shape masking."""
    L = cfg.dp_layers
    K = cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    lat_ds = cfg.search_lateral_spacing

    proj_s = project(xs, ys, start_x, start_y, length)
    search_ds = cfg.search_longitudinal_spacing if length > 6.0 else 0.5
    n_interior = int(np.ceil((length - proj_s) / search_ds - 1e-6))
    n_layers = int(np.clip(n_interior + 1, 1, L))
    layers_s = np.array([proj_s + j * search_ds if j < n_layers - 1 else length
                         for j in range(n_layers)])

    px, py = float(xs(proj_s)), float(ys(proj_s))
    ph = float(heading_of(xs, ys, proj_s))
    _, vehicle_l = global_to_local(px, py, ph, start_x, start_y)
    ok = abs(vehicle_l) <= lat_range
    start_idx = int(np.clip(int((lat_range + vehicle_l) / lat_ds), 0, K - 1))

    lat = -lat_range + lat_ds * np.arange(K)
    ref_x = xs(layers_s)
    ref_y = ys(layers_s)
    ref_h = heading_of(xs, ys, layers_s)
    ref_k = curvature_of(xs, ys, layers_s)
    node_x, node_y = normal_offset(ref_x[:, None], ref_y[:, None],
                                   ref_h[:, None], lat[None, :])
    inside = is_inside(m, node_x, node_y)
    dis = np.where(inside, obstacle_distance(m, node_x, node_y), -1.0)
    threshold = cfg.car_width / 2.0 + 0.2
    # Signed turn radius (reference :182); sign-preserving epsilon clamp.
    ref_r = 1.0 / np.where(np.abs(ref_k) < 1e-9,
                           np.where(ref_k < 0, -1e-9, 1e-9), ref_k)
    radius_bad = ((ref_k[:, None] < 0) & (lat[None, :] < ref_r[:, None])) | \
                 ((ref_k[:, None] > 0) & (lat[None, :] > ref_r[:, None]))
    feasible = ~(radius_bad | (dis < threshold)) & (lat[None, :] <= lat_range)
    feasible[0] = np.arange(K) == start_idx

    # Rough bounds: start of the contiguous feasible run containing k.
    rough_lb = np.zeros((n_layers, K))
    rough_ub = np.zeros((n_layers, K))
    for j in range(n_layers):
        for k in range(K):
            lb = lat[k]
            kk = k
            while kk > 0 and feasible[j, kk] and feasible[j, kk - 1]:
                kk -= 1
                lb = lat[kk]
            rough_lb[j, k] = lb
            ub = lat[k]
            kk = k
            while kk < K - 1 and feasible[j, kk] and feasible[j, kk + 1]:
                kk += 1
                ub = lat[kk]
            rough_ub[j, k] = ub

    safe = cfg.dp_safe_distance
    self_cost = np.where(dis < safe, (safe - dis) / safe * cfg.dp_weight_obstacle,
                         0.0)
    self_cost = self_cost + np.abs(lat)[None, :] / lat_range \
        * cfg.dp_weight_ref_offset

    cost = np.full((n_layers, K), _INF)
    parent = np.zeros((n_layers, K), int)
    direction = np.full((n_layers, K), start_heading)
    cost[0, start_idx] = 0.0
    alive = [True]
    for j in range(1, n_layers):
        layer_any = False
        for k in range(K):
            if not feasible[j, k]:
                continue
            best, best_p, best_dir = _INF, 0, ref_h[j]
            for kp in range(K):
                if cost[j - 1, kp] >= _INF:
                    continue
                if abs(lat[k] - lat[kp]) > (layers_s[j] - layers_s[j - 1]):
                    continue
                d = math.atan2(node_y[j, k] - node_y[j - 1, kp],
                               node_x[j, k] - node_x[j - 1, kp])
                edge = (abs(constrain_angle(d - direction[j - 1, kp]))
                        / (np.pi / 2) * cfg.dp_weight_angle_change
                        + abs(constrain_angle(d - ref_h[j]))
                        / (np.pi / 2) * cfg.dp_weight_ref_angle_diff)
                total = cost[j - 1, kp] + edge + self_cost[j, k]
                if total < best:
                    best, best_p = total, kp
                    best_dir = d
            if best < _INF:
                cost[j, k] = best
                parent[j, k] = best_p
                direction[j, k] = best_dir
                layer_any = True
        alive.append(alive[-1] and layer_any)
        if not alive[-1]:
            cost[j] = _INF
    max_layer = max(j for j in range(n_layers) if alive[j])

    path_k = np.zeros(max_layer + 1, int)
    path_k[max_layer] = int(np.argmin(cost[max_layer]))
    for j in range(max_layer, 0, -1):
        path_k[j - 1] = parent[j, path_k[j]]

    def expand(j, base, sign, thr):
        pos = base
        while sign * pos < 6.0:
            cx, cy = normal_offset(ref_x[j], ref_y[j], ref_h[j], pos)
            if not (is_inside(m, cx, cy)
                    and obstacle_distance(m, cx, cy) > thr):
                return pos - sign * 0.2
            pos += sign * 0.2
        return pos

    lower = np.zeros(max_layer + 1)
    upper = np.zeros(max_layer + 1)
    lower[0], upper[0] = -10.0, 10.0
    for j in range(1, max_layer + 1):
        upper[j] = expand(j, rough_ub[j, path_k[j]] + 0.2, +1.0, threshold)
        lower[j] = expand(j, rough_lb[j, path_k[j]] - 0.2, -1.0, threshold)

    return dict(layers_s=layers_s[:max_layer + 1], lower=lower, upper=upper,
                n_layers=max_layer + 1, vehicle_l=vehicle_l, ok=ok,
                ref_x=ref_x[:max_layer + 1], ref_y=ref_y[:max_layer + 1],
                ref_h=ref_h[:max_layer + 1])


# ------------------------ stage 5: post-smoothing QP -------------------------

def post_smooth(layers_s, lower, upper, vehicle_l, cfg: PlannerConfig,
                eps=None):
    """postSmooth (reference_path_smoother.cpp:526-636), dense float64."""
    L = len(layers_s)
    nv = 3 * L
    nc = 3 * L - 2
    li, dli, ddli = 0, L, 2 * L
    P = np.diag(np.concatenate([
        np.full(L, cfg.post_weight_l),
        np.full(L, cfg.post_weight_dl),
        np.full(L, cfg.post_weight_ddl)]))
    q = np.zeros(nv)
    ds = np.diff(layers_s)
    ds = np.where(ds > 1e-6, ds, 1.0)
    A = np.zeros((nc, nv))
    for i in range(L):
        A[i, li + i] = 1.0
    for i in range(L - 1):
        A[L + i, li + i + 1] = 1.0
        A[L + i, li + i] = -1.0
        A[L + i, dli + i] = -ds[i]
        r = L + (L - 1) + i
        A[r, dli + i + 1] = 1.0
        A[r, dli + i] = -1.0
        A[r, ddli + i] = -ds[i]
    lb = np.concatenate([lower, np.zeros(2 * (L - 1))]).astype(np.float64)
    ub = np.concatenate([upper, np.zeros(2 * (L - 1))]).astype(np.float64)
    lb[0] = ub[0] = vehicle_l
    sol = qp_oracle.solve(P, q, A, lb, ub, **_qp_kwargs(cfg, eps))
    return sol.x[:L], sol.status == "solved"


# --------------------- stage 6: init/trim/resample/bounds --------------------

def build_reference_from_spline(xs, ys, max_s, cfg: PlannerConfig):
    """buildReferenceFromSpline (reference_path_impl.cpp:314-338) incl.
    curvature-adaptive dynamic segmentation, capped at the static n_knots."""
    ds = cfg.output_spacing
    N = cfg.n_knots
    if cfg.enable_dynamic_segmentation:
        ds_small = ds / 2.0
        large_k, small_k = 0.2, 0.08
        s_list = []
        s_cur = 0.0
        for _ in range(N):
            s_list.append(s_cur)
            k_i = float(curvature_of(xs, ys, s_cur))
            share = np.clip((abs(k_i) - small_k) / (large_k - small_k),
                            0.0, 1.0)
            s_cur = s_cur + ds - share * (ds - ds_small)
        s = np.array(s_list)
        n_valid = int(np.sum(s <= max_s))
        truncated = s[-1] < max_s
        s = np.minimum(s, max_s)[:n_valid]
    else:
        n_valid = min(int(np.floor(max_s / ds)) + 1, N)
        truncated = (N - 1) * ds < max_s
        s = np.arange(n_valid) * ds
    return dict(x=xs(s), y=ys(s), heading=heading_of(xs, ys, s),
                k=curvature_of(xs, ys, s), s=s, n_valid=n_valid,
                truncated=bool(truncated))


_COARSE_DS, _FINE_DS, _SEARCH_RADIUS = 0.3, 0.05, 0.5
_COARSE_STEPS, _FINE_STEPS = 20, 5


def clearance_strict(m, x, y, heading, cfg: PlannerConfig):
    """getClearanceWithDirectionStrict (reference_path_impl.cpp:232-312),
    with the repo's documented right-side-refinement fix (bounds.py:48-60)."""
    if obstacle_distance(m, x, y) <= _SEARCH_RADIUS:
        return 0.0, 0.0

    def march(angle):
        hits = _COARSE_STEPS
        for i in range(1, _COARSE_STEPS + 1):
            px = x + i * _COARSE_DS * math.cos(angle)
            py = y + i * _COARSE_DS * math.sin(angle)
            if obstacle_distance(m, px, py) < _SEARCH_RADIUS:
                hits = i - 1
                break
        base = (hits if hits < _COARSE_STEPS else _COARSE_STEPS - 1) * _COARSE_DS
        good = _FINE_STEPS
        for i in range(1, _FINE_STEPS + 1):
            px = x + (base + i * _FINE_DS) * math.cos(angle)
            py = y + (base + i * _FINE_DS) * math.sin(angle)
            if obstacle_distance(m, px, py) < _SEARCH_RADIUS:
                good = i - 1
                break
        return base + good * _FINE_DS

    left_b = march(heading + np.pi / 2)
    right_b = march(heading - np.pi / 2)
    diff_radius = cfg.car_width * 0.5 - _SEARCH_RADIUS
    left = left_b - diff_radius
    right = -(right_b - diff_radius)
    if left < right:
        return 0.0, 0.0
    space = left - right
    margin = min(cfg.safety_margin, max(0.0, (space - 0.2) / 2.0))
    return left - margin, right + margin


def update_bounds(m, xs, ys, ref, cfg: PlannerConfig, with_center=False):
    """updateBoundsImproved (reference_path_impl.cpp:177-230) + blocked
    truncation. ``with_center`` adds the center-state corridor (:207),
    consumed only by the rough far-away rows (base_solver.cpp:241-246)."""
    n = ref["n_valid"]
    out = {}
    if with_center:
        c_ub = np.zeros(n)
        c_lb = np.zeros(n)
        for i in range(n):
            left, right = clearance_strict(m, ref["x"][i], ref["y"][i],
                                           ref["heading"][i], cfg)
            c_ub[i], c_lb[i] = left, right
        out["center_ub"] = c_ub
        out["center_lb"] = c_lb
    for name, length in (("front", cfg.front_length), ("rear", cfg.rear_length)):
        ub = np.zeros(n)
        lb = np.zeros(n)
        for i in range(n):
            h = ref["heading"][i]
            cx = ref["x"][i] + length * math.cos(h)
            cy = ref["y"][i] + length * math.sin(h)
            proj_s = project_directional_newton(
                xs, ys, cx, cy, h + np.pi / 2, ref["s"][i] + 5.0,
                ref["s"][i] + length, cfg.newton_iters)
            px, py = float(xs(proj_s)), float(ys(proj_s))
            left, right = clearance_strict(m, px, py, h, cfg)
            _, off = global_to_local(cx, cy, h, px, py)
            ub[i] = left + off
            lb[i] = right + off
        out[name + "_ub"] = ub
        out[name + "_lb"] = lb

    zero_width = (np.abs(out["front_ub"] - out["front_lb"]) < cfg.epsilon) | \
                 (np.abs(out["rear_ub"] - out["rear_lb"]) < cfg.epsilon)
    blocked = bool(zero_width.any())
    n_valid = int(np.argmax(zero_width)) if blocked else n
    out.update(blocked=blocked, n_valid=min(n, n_valid))
    return out


# ------------------------- stage 7: two-pass path QP -------------------------

NB = 6  # [l, e_psi, kappa, u, s_front, s_rear] per knot (assembly.py layout)


def soft_bounds(lb, ub, margin, min_clearance=0.1):
    clearance = ub - lb
    remain = np.maximum(min_clearance, clearance - 2.0 * margin)
    shrink = np.maximum(0.0, (clearance - remain) / 2.0)
    return lb + shrink, ub - shrink


def assemble_path_qp(ref, cb, input_l, input_e, input_k, init_offset,
                     init_heading_error, start_k, target_heading, blocked,
                     cfg: PlannerConfig):
    """BaseSolver cost+constraints (base_solver.cpp:119-261), dense float64,
    knot-major variable ordering (matching solver.assembly.to_dense)."""
    n = cb["n_valid"]
    s = ref["s"][:n]
    ref_k = ref["k"][:n]
    nv = n * NB
    nc = n * 6 + 2

    P = np.diag(np.tile([cfg.weight_l, 0.0, cfg.weight_kappa,
                         cfg.weight_dkappa, cfg.weight_slack,
                         cfg.weight_slack], n))
    q = np.zeros(nv)
    A = np.zeros((nc, nv))
    lb = np.zeros(nc)
    ub = np.zeros(nc)

    ds = np.diff(s)
    ds = np.where(ds > 1e-6, ds, 1.0)
    for i in range(n):
        r = i * 6
        # Transition rows: -x_i + A_{i-1} x_{i-1} + B_{i-1} u_{i-1} = rhs.
        A[r:r + 3, i * NB:i * NB + 3] = -np.eye(3)
        if i == 0:
            rhs = -np.array([init_offset, init_heading_error, start_k])
        else:
            lb_, eb_, kb_ = input_l[i - 1], input_e[i - 1], input_k[i - 1]
            cos_e, tan_e = math.cos(eb_), math.tan(eb_)
            one_kl = 1.0 - kb_ * lb_
            df = np.array([
                [-kb_ * tan_e, one_kl / cos_e ** 2, 0.0],
                [-kb_ ** 2 / cos_e, one_kl * kb_ * tan_e / cos_e,
                 one_kl / cos_e],
                [0.0, 0.0, 0.0]])
            Ai = np.eye(3) + ds[i - 1] * df
            Bi = ds[i - 1] * np.array([0.0, 0.0, 1.0])
            u_in = (input_k[i] - input_k[i - 1]) / ds[i - 1]
            f = np.array([one_kl * tan_e,
                          one_kl * kb_ / cos_e - ref_k[i - 1],
                          u_in])
            xbar = np.array([lb_, eb_, kb_])
            ci = ds[i - 1] * (f - df @ xbar - Bi * u_in)
            A[r:r + 3, (i - 1) * NB:(i - 1) * NB + 3] += Ai
            A[r:r + 3, (i - 1) * NB + 3] += Bi
            rhs = -ci
        lb[r:r + 3] = ub[r:r + 3] = rhs
        # Curvature row.
        A[r + 3, i * NB + 2] = 1.0
        lb[r + 3], ub[r + 3] = -cfg.kappa_limit, cfg.kappa_limit
        # Collision rows. With rough_constraints_far_away, knots at
        # s >= precise_planning_length drop to a single center-corridor row
        # with one slack (base_solver.cpp:25-37, :193-206, :232-248); the
        # second row pins the unused rear slack to 0 — the engine's
        # fixed-shape scheme (solver/assembly.py), whose optimum over
        # (l, e, k, u) coincides with the reference's reduced-variable
        # layout (a penalized, otherwise-unconstrained slack sits at 0).
        rough_i = (cfg.rough_constraints_far_away
                   and s[i] >= cfg.precise_planning_length)
        if rough_i:
            A[r + 4, i * NB + 0] = 1.0
            A[r + 4, i * NB + 4] = 1.0
            A[r + 5, i * NB + 5] = 1.0
            clb, cub = soft_bounds(cb["center_lb"][i], cb["center_ub"][i],
                                   cfg.expected_safety_margin)
            lb[r + 4], ub[r + 4] = clb, cub
            lb[r + 5], ub[r + 5] = 0.0, 0.0
        else:
            A[r + 4, i * NB + 0] = 1.0
            A[r + 4, i * NB + 1] = cfg.front_length
            A[r + 4, i * NB + 4] = 1.0
            A[r + 5, i * NB + 0] = 1.0
            A[r + 5, i * NB + 1] = cfg.rear_length
            A[r + 5, i * NB + 5] = 1.0
            flb, fub = soft_bounds(cb["front_lb"][i], cb["front_ub"][i],
                                   cfg.expected_safety_margin)
            rlb, rub = soft_bounds(cb["rear_lb"][i], cb["rear_ub"][i],
                                   cfg.expected_safety_margin)
            lb[r + 4], ub[r + 4] = flb, fub
            lb[r + 5], ub[r + 5] = rlb, rub

    # End rows (base_solver.cpp:249-260; the reference's no-abs 70 deg quirk).
    ei = n - 1
    A[n * 6, ei * NB + 0] = 1.0
    lb[n * 6], ub[n * 6] = -1.0, 1.0
    A[n * 6 + 1, ei * NB + 1] = 1.0
    end_psi = constrain_angle(target_heading - ref["heading"][ei])
    use_heading = (cfg.constraint_end_heading and not blocked
                   and end_psi < 70.0 * np.pi / 180.0)
    if use_heading:
        lb[n * 6 + 1], ub[n * 6 + 1] = end_psi - 0.087, end_psi + 0.087
    else:
        lb[n * 6 + 1], ub[n * 6 + 1] = -INFTY, INFTY
    return P, q, A, lb, ub


def solve_path_qp_two_pass(ref, cb, init_offset, init_heading_error, start_k,
                           target_heading, cfg: PlannerConfig, eps=None,
                           cast=keep):
    n = cb["n_valid"]
    kw = _qp_kwargs(cfg, eps)
    zeros = np.zeros(n)
    P, q, A, lb, ub = assemble_path_qp(
        ref, cb, zeros, zeros, ref["k"][:n], init_offset, init_heading_error,
        start_k, target_heading, cb["blocked"], cfg)
    sol1 = qp_oracle.solve(P, q, A, lb, ub, **kw)
    v1 = cast(sol1.x.reshape(n, NB))
    P, q, A, lb, ub = assemble_path_qp(
        ref, cb, v1[:, 0], v1[:, 1], v1[:, 2], init_offset,
        init_heading_error, start_k, target_heading, cb["blocked"], cfg)
    sol2 = qp_oracle.solve(P, q, A, lb, ub, x0=sol1.x, y0=sol1.y, **kw)
    return sol1, sol2


# ------------------------------ full pipeline --------------------------------

def solve(m: OracleMap, raw_x, raw_y, start, target, cfg: PlannerConfig,
          eps=None, cast=keep):
    """The whole chain for one query. start: (x, y, heading[, curvature]),
    target: (x, y, heading). Returns a dict of per-stage intermediates and
    the final SlState path. ``cast`` is applied to every value that passes
    from one stage to the next (the identity: float64 throughout)."""
    out = {}
    raw_x, raw_y = cast(np.asarray(raw_x)), cast(np.asarray(raw_y))
    start_x, start_y, start_heading, *k0 = map(float, cast(np.asarray(
        start, np.float64)))
    target_x, target_y, target_heading = map(float, cast(np.asarray(
        target, np.float64)))
    start_k = k0[0] if k0 else 0.0

    # Stage 1+2: B-spline fit + 1 m segmentation.
    xb, yb, sb = map(cast, bspline_fit_and_sample(raw_x, raw_y))
    *seg, n_seg = segment_raw_reference(xb, yb, sb, cfg.n_segment_points)
    xg, yg, sg, ang, kg = map(cast, seg)
    out["seg"] = dict(x=xg, y=yg, s=sg, n=n_seg, angle=ang)

    # Stage 3: the TENSION2 smoothing QP.
    x2, y2, conv_smooth = tension2_smooth(xg, yg, ang, kg, sg, cfg, eps)
    x2, y2 = cast(x2), cast(y2)
    out["smooth"] = dict(x=x2, y=y2, ok=conv_smooth)

    # Stage 4: smoothed refit + DP corridor search (the reference extends
    # 3 m past the fit, tension_smoother.cpp:40-41).
    xs2, ys2, s2_max = refit_xy(x2, y2)
    cor = search_corridor(m, xs2, ys2, s2_max + 3.0, start_x, start_y,
                          start_heading, cfg)
    cor = {k: cast(v) if isinstance(v, (np.ndarray, float)) else v
           for k, v in cor.items()}
    out["corridor"] = cor

    # Stage 5: post-smoothing QP (>= 4 layers required, :528-531).
    ok_post = cor["n_layers"] >= 4
    l_post, conv_post = post_smooth(cor["layers_s"], cor["lower"],
                                    cor["upper"], cor["vehicle_l"], cfg, eps)
    l_post = cast(l_post)
    out["post"] = dict(l=l_post, ok=ok_post and conv_post)

    # Stage 6: re-projection, init state, trim, resample, bounds
    # (processReferencePath, path_optimizer.cpp:105-122).
    x3, y3 = normal_offset(cor["ref_x"], cor["ref_y"], cor["ref_h"], l_post)
    xs3, ys3, length3 = refit_xy(cast(x3), cast(y3))

    ix, iy = float(xs3(0.0)), float(ys3(0.0))
    ih = float(heading_of(xs3, ys3, 0.0))
    _, local_y = global_to_local(ix, iy, ih, start_x, start_y)
    min_dist = math.hypot(ix - start_x, iy - start_y)
    init_offset = min_dist if local_y < 0.0 else -min_dist
    init_heading_error = float(constrain_angle(start_heading - ih))
    init_offset, init_heading_error = map(float, cast(np.array(
        [init_offset, init_heading_error])))
    ok_init = abs(init_heading_error) <= 75.0 * np.pi / 180.0

    ex, ey = float(xs3(length3)), float(ys3(length3))
    eh = float(heading_of(xs3, ys3, length3))
    local_tx, _ = global_to_local(ex, ey, eh, target_x, target_y)
    if local_tx <= 0.0:
        length3 = project(xs3, ys3, target_x, target_y, length3)

    ref = build_reference_from_spline(xs3, ys3, length3, cfg)
    ref = {k: cast(v) if isinstance(v, np.ndarray) else v
           for k, v in ref.items()}
    cb = update_bounds(m, xs3, ys3, ref, cfg,
                       with_center=cfg.rough_constraints_far_away)
    cb = {k: cast(v) if isinstance(v, np.ndarray) else v
          for k, v in cb.items()}
    n_valid = cb["n_valid"]
    out["ref"] = ref
    out["bounds"] = cb
    out["init"] = dict(offset=init_offset, heading_error=init_heading_error,
                       ok=ok_init, n_valid=n_valid)

    # Stage 7: two-pass path QP.
    sol1, sol2 = solve_path_qp_two_pass(
        ref, cb, init_offset, init_heading_error, start_k, target_heading,
        cfg, eps, cast)
    v = cast(sol2.x.reshape(n_valid, NB))
    out["qp"] = dict(sol1=sol1, sol2=sol2,
                     ok=(sol1.status == "solved" and sol2.status == "solved"))

    # Stage 8: output path (getOptimizedPath, base_solver.cpp:263-288).
    l, e, k, dk = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    hh = ref["heading"][:n_valid]
    x_out, y_out = normal_offset(ref["x"][:n_valid], ref["y"][:n_valid], hh, l)
    out["path"] = dict(
        x=cast(x_out), y=cast(y_out), heading=cast(constrain_angle(hh + e)),
        l=l, d_heading=e, k=k, d_k=dk, n_valid=n_valid,
        blocked=cb["blocked"],
        ok=(out["smooth"]["ok"] and cor["ok"] and out["post"]["ok"]
            and ok_init and out["qp"]["ok"]))
    return out
