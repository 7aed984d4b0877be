"""DP corridor search over the Frenet lattice, batched (port of
``tpu_pathopt.corridor``; reference: graphSearchDp,
reference_path_smoother.cpp:142-295).

Sample a lattice of lateral offsets on longitudinal layers along the smoothed
reference (:func:`prepare_lattice`), run the layer-sequential dynamic program
(:func:`dp_forward`, kernel K4 in ``csrc/dp_forward.cu``, beside its plain
version :func:`dp_forward_plain`), backtrack the cheapest node of the deepest
reachable layer and widen each backtracked node's corridor by ESDF
ray-marching (:func:`finish_corridor`). :func:`search_corridor_astar` is the
reference's A* variant (graphSearch, :297-484) on the same lattice, as plain
tensor code. Every array is batch-leading.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_pathopt_torch import kernels, maps, splines
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import (constrain_angle, global_to_local,
                                        normal_offset)

_INF = 1e30
_CHECK_S = 0.2
_CHECK_LIMIT = 6.0
# Worst-case march span: (6 - (-10)) / 0.2 = 80 steps, +2 for the initial
# offset step and the final step-back.
_EXPAND_STEPS = 82


@dataclasses.dataclass
class Corridor:
    layers_s: torch.Tensor    # (B, L)
    lower: torch.Tensor       # (B, L)
    upper: torch.Tensor       # (B, L)
    n_layers: torch.Tensor    # (B,) int64: valid layers (deepest reached + 1)
    vehicle_l: torch.Tensor   # (B,) lateral offset of the vehicle
    ok: torch.Tensor          # (B,) bool


@dataclasses.dataclass
class DpLattice:
    """Everything the DP forward pass and the corridor finish need
    (the lattice construction half of graphSearchDp, :148-226)."""

    layers_s: torch.Tensor    # (B, L)
    n_layers: torch.Tensor    # (B,) int64
    vehicle_l: torch.Tensor   # (B,)
    ok: torch.Tensor          # (B,) bool
    ref_x: torch.Tensor       # (B, L)
    ref_y: torch.Tensor
    ref_h: torch.Tensor
    rough_lb: torch.Tensor    # (B, L, K)
    rough_ub: torch.Tensor
    dir_all: torch.Tensor     # (B, L-1, Kp, K) edge directions between layers
    base_all: torch.Tensor    # (B, L-1, Kp, K) state-independent edge costs
    cost0: torch.Tensor       # (B, K) layer-0 costs (0 at the start node)
    dir0: torch.Tensor        # (B, K) layer-0 incoming direction


def _hold_from_run_start(feas, vals, reverse):
    """``vals`` held from the start of the contiguous feasible run holding
    each lateral index (the reference's nearest-infeasible-neighbor scans,
    :210-226), along the last axis."""
    if reverse:
        feas, vals = feas.flip(-1), vals.flip(-1)
    K = feas.shape[-1]
    prev = torch.cat([torch.zeros_like(feas[..., :1]), feas[..., :-1]], -1)
    new_run = ~(feas & prev)
    idx = torch.arange(K, device=feas.device).expand(feas.shape)
    start = torch.cummax(torch.where(new_run, idx, -1), dim=-1).values
    out = torch.gather(vals, -1, start)
    return out.flip(-1) if reverse else out


@dataclasses.dataclass
class _LatticeGeom:
    """Lattice geometry shared by the DP and A* searches (reference
    :148-199 and :304-347 differ only in the feasibility rule, which stays
    with each search)."""

    layers_s: torch.Tensor    # (B, L)
    n_layers: torch.Tensor    # (B,) int64
    vehicle_l: torch.Tensor   # (B,)
    ok: torch.Tensor          # (B,) bool
    lat: torch.Tensor         # (K,) lateral offsets
    ref_x: torch.Tensor       # (B, L)
    ref_y: torch.Tensor
    ref_h: torch.Tensor
    ref_k: torch.Tensor       # (B, L) reference curvature at the layers
    ref_r: torch.Tensor       # (B, L) signed turn radius 1/k
    node_x: torch.Tensor      # (B, L, K) lattice node positions
    node_y: torch.Tensor
    dis: torch.Tensor         # (B, L, K) node clearance (-1 outside the map)


def _build_lattice_geom(gm: maps.GridMap, xs: splines.CubicSpline,
                        ys: splines.CubicSpline, length, start_x, start_y,
                        config: PlannerConfig) -> _LatticeGeom:
    """Layers, vehicle projection and node sampling (:148-199; the A*
    search repeats the same construction at :304-347)."""
    cfg = config
    L, K = cfg.dp_layers, cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    dev = length.device
    f32 = torch.float32

    # --- Layer longitudinal positions (:148-158) ---
    proj_s = splines.project(xs, ys, start_x, start_y, length,
                             iters=cfg.newton_iters)
    search_ds = torch.where(length > 6.0, cfg.search_longitudinal_spacing,
                            0.5)
    j = torch.arange(L, dtype=f32, device=dev)
    n_interior = torch.ceil((length - proj_s) / search_ds - 1e-6).long()
    n_layers = torch.clamp(n_interior + 1, 1, L)
    layers_s = torch.where(j < (n_layers - 1)[:, None].to(f32),
                           proj_s[:, None] + j * search_ds[:, None],
                           length[:, None])

    # --- Vehicle lateral offset wrt the smoothed reference (:160-169) ---
    px = splines.evaluate(xs, proj_s)
    py = splines.evaluate(ys, proj_s)
    ph = splines.heading(xs, ys, proj_s)
    _, vehicle_l, _ = global_to_local(px, py, ph, start_x, start_y)
    ok = torch.abs(vehicle_l) <= lat_range

    # --- Lattice nodes (:171-199) ---
    lat = -lat_range + cfg.search_lateral_spacing * torch.arange(
        K, dtype=f32, device=dev)
    ref_x = splines.evaluate(xs, layers_s)                       # (B, L)
    ref_y = splines.evaluate(ys, layers_s)
    ref_h = splines.heading(xs, ys, layers_s)
    ref_k = splines.curvature(xs, ys, layers_s)
    node_x, node_y = normal_offset(ref_x[..., None], ref_y[..., None],
                                   ref_h[..., None], lat)        # (B, L, K)
    inside = maps.is_inside(gm, node_x, node_y)
    dis = torch.where(inside, maps.obstacle_distance(gm, node_x, node_y),
                      -1.0)
    # Signed turn radius 1/k; the epsilon clamp preserves the sign.
    ref_r = 1.0 / torch.where(torch.abs(ref_k) < 1e-9,
                              torch.where(ref_k < 0, -1e-9, 1e-9), ref_k)
    return _LatticeGeom(layers_s=layers_s, n_layers=n_layers,
                        vehicle_l=vehicle_l.to(f32), ok=ok, lat=lat,
                        ref_x=ref_x, ref_y=ref_y, ref_h=ref_h, ref_k=ref_k,
                        ref_r=ref_r, node_x=node_x, node_y=node_y, dis=dis)


def _rough_bounds(feasible, lat):
    """Per-layer rough (lb, ub) (B, L, K) from lateral feasibility
    contiguity (:210-226 / :349-361)."""
    lat_grid = lat.expand(feasible.shape)
    return (_hold_from_run_start(feasible, lat_grid, reverse=False),
            _hold_from_run_start(feasible, lat_grid, reverse=True))


def prepare_lattice(gm: maps.GridMap, xs: splines.CubicSpline,
                    ys: splines.CubicSpline, length, start_x, start_y,
                    start_heading, config: PlannerConfig) -> DpLattice:
    """Layers, vehicle projection, node sampling, feasibility, rough bounds
    and every state-independent DP edge cost (:148-238). Per-scenario
    inputs are (B,)."""
    cfg = config
    L, K = cfg.dp_layers, cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    dev = length.device
    f32 = torch.float32
    g = _build_lattice_geom(gm, xs, ys, length, start_x, start_y, cfg)
    layers_s, n_layers, lat, dis = g.layers_s, g.n_layers, g.lat, g.dis
    node_x, node_y, ref_h = g.node_x, g.node_y, g.ref_h
    start_idx = ((lat_range + g.vehicle_l) / cfg.search_lateral_spacing
                 ).to(torch.int32).long().clamp(0, K - 1)

    # --- DP feasibility rule (:176-205) ---
    threshold = cfg.car_width / 2.0 + 0.2
    rk, rr = g.ref_k[..., None], g.ref_r[..., None]
    radius_bad = ((rk < 0) & (lat < rr)) | ((rk > 0) & (lat > rr))
    feasible = ~(radius_bad | (dis < threshold)) & (lat <= lat_range)
    k_idx = torch.arange(K, device=dev)
    # Layer 0: only the start node, forced feasible (:200-205).
    feasible[:, 0] = k_idx == start_idx[:, None]

    # --- Rough per-layer bounds over the lateral axis (:210-226) ---
    rough_lb, rough_ub = _rough_bounds(feasible, lat)

    # --- State-independent DP edge costs (:228-238, calculateCostAt) ---
    safe_dist = cfg.dp_safe_distance
    self_cost = torch.where(dis < safe_dist,
                            (safe_dist - dis) / safe_dist
                            * cfg.dp_weight_obstacle, 0.0)
    self_cost = self_cost + torch.abs(lat) / lat_range * cfg.dp_weight_ref_offset

    in_mask = torch.arange(1, L, device=dev) < n_layers[:, None]
    feas_in = feasible[:, 1:] & in_mask[..., None]               # (B, L-1, K)
    dir_all = torch.atan2(node_y[:, 1:, None, :] - node_y[:, :-1, :, None],
                          node_x[:, 1:, None, :] - node_x[:, :-1, :, None])
    term2 = torch.abs(constrain_angle(dir_all - ref_h[:, 1:, None, None])) \
        / (math.pi / 2) * cfg.dp_weight_ref_angle_diff
    lat_ok = (torch.abs(lat[None, None, None, :] - lat[None, None, :, None])
              <= (layers_s[:, 1:] - layers_s[:, :-1])[..., None, None])
    base_all = torch.where(lat_ok & feas_in[:, :, None, :],
                           term2 + self_cost[:, 1:, None, :], _INF)

    cost0 = torch.where(k_idx == start_idx[:, None], 0.0, _INF)
    dir0 = start_heading.to(f32)[:, None].expand(-1, K).contiguous()
    return DpLattice(layers_s=layers_s, n_layers=n_layers,
                     vehicle_l=g.vehicle_l, ok=g.ok, ref_x=g.ref_x,
                     ref_y=g.ref_y, ref_h=ref_h, rough_lb=rough_lb,
                     rough_ub=rough_ub, dir_all=dir_all, base_all=base_all,
                     cost0=cost0, dir0=dir0)


# --------------------------------- K4 ---------------------------------------

def first_argmin(total):
    """(min over kp, the smallest kp attaining it) of total (B, Kp, K), the
    kp index int32."""
    Kp = total.shape[1]
    kp_iota = torch.arange(Kp, dtype=torch.int32,
                           device=total.device)[None, :, None]
    best_cost = torch.amin(total, dim=1)                         # (B, K)
    best_prev = torch.amin(torch.where(total == best_cost[:, None],
                                       kp_iota, Kp), dim=1)
    return best_cost, best_prev


def dp_forward_plain(dir_all, base_all, h_in, cost0, dir0, w1: float):
    """K4's plain version: the DP forward pass as a loop over layers.

    dir_all/base_all (B, L-1, Kp, K), h_in (B, L-1), cost0/dir0 (B, K).
    Returns (costs (B, L-1, K) float32, parents (B, L-1, K) int32,
    alives (B, L-1) bool). Every step is one correctly rounded float32
    operation, so the CUDA kernel reproduces it bit for bit."""
    B, lm1, Kp, _ = dir_all.shape
    dev = dir_all.device
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the correctly rounded quotient.
    half_pi = torch.tensor(math.pi / 2, dtype=torch.float32, device=dev)
    cost_p, dir_p = cost0, dir0
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    costs, parents, alives = [], [], []
    for layer in range(lm1):
        direction = dir_all[:, layer]
        t1 = torch.abs(constrain_angle(direction - dir_p[:, :, None])) \
            / half_pi * w1
        total = cost_p[:, :, None] + t1 + base_all[:, layer]
        best_cost, best_prev = first_argmin(total)
        best_dir = torch.gather(direction, 1,
                                best_prev[:, None].long())[:, 0]
        alive = alive & torch.any(best_cost < _INF, dim=-1)
        cost_p = torch.where(alive[:, None], best_cost, _INF)
        dir_p = torch.where(best_cost < _INF, best_dir,
                            h_in[:, layer, None])
        costs.append(cost_p)
        parents.append(best_prev)
        alives.append(alive)
    return (torch.stack(costs, 1), torch.stack(parents, 1).to(torch.int32),
            torch.stack(alives, 1))


def dp_forward(dir_all, base_all, h_in, cost0, dir0, w1: float):
    """The DP forward pass (K4, ``csrc/dp_forward.cu``), same arguments and
    results as :func:`dp_forward_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream. The
    launcher splits each lateral's parent scan over the block's threads and
    refuses a lattice of more than 119 laterals, whose block would not fit
    in shared memory."""
    dev = kernels.kernel_device(dir_all)
    if dev is None:
        return dp_forward_plain(dir_all, base_all, h_in, cost0, dir0, w1)
    B, lm1, Kp, K = dir_all.shape
    if Kp != K:
        raise ValueError(f"dp_forward: lattice ({Kp}, {K}), the kernel takes "
                         "a square lattice")
    f32 = torch.float32
    for name, t, shape in (("dir_all", dir_all, (B, lm1, K, K)),
                           ("base_all", base_all, (B, lm1, K, K)),
                           ("h_in", h_in, (B, lm1)), ("cost0", cost0, (B, K)),
                           ("dir0", dir0, (B, K))):
        kernels.expect(name, t, shape, f32, dev)
    costs = torch.empty((B, lm1, K), dtype=f32, device=dev)
    parents = torch.empty((B, lm1, K), dtype=torch.int32, device=dev)
    alives = torch.empty((B, lm1), dtype=torch.uint8, device=dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_dp_forward(
        p(dir_all), p(base_all), p(h_in), p(cost0), p(dir0), p(costs),
        p(parents), p(alives), B, lm1, K, float(w1), kernels.stream_ptr(dev))
    kernels.check(err, "dp_forward")
    kernels.count_launch("dp_forward", f"K={K}")
    return costs, parents, alives.bool()


def dp_forward_batched(lat: DpLattice, config: PlannerConfig):
    """DP forward over a batched lattice (K4 on CUDA tensors)."""
    return dp_forward(lat.dir_all.contiguous(), lat.base_all.contiguous(),
                      lat.ref_h[:, 1:].contiguous(), lat.cost0.contiguous(),
                      lat.dir0.contiguous(), config.dp_weight_angle_change)


# ------------------------------ corridor finish ------------------------------

def _backtrack(parents, max_layer, best_k_last):
    """Reverse walk from the best node of the deepest reached layer
    (:240-287). parents (B, L, K); returns path_k (B, L)."""
    L = parents.shape[1]
    k_next = best_k_last
    path = [None] * L
    for layer in range(L - 1, -1, -1):
        k = torch.where(max_layer == layer, best_k_last, k_next)
        k_prev = torch.gather(parents[:, layer], 1, k[:, None])[:, 0].long()
        path[layer] = k
        k_next = torch.where(layer <= max_layer, k_prev, k_next)
    return torch.stack(path, 1)


def _expand_corridor(gm, ref_x, ref_y, ref_h, rough_lb, rough_ub, path_k,
                     max_layer, thr_up, thr_lo):
    """Corridor expansion around the backtracked nodes (:250-287): march
    from each node's rough bound in 0.2 m steps while |pos| < 6 m and the
    ESDF clearance stays above the threshold; on the first failure step
    back once. Layer 0 gets the full +-10 m range; layers beyond the path
    are 0. Returns (lower, upper), each (B, L)."""
    f32 = torch.float32
    dev = ref_x.device
    L = ref_x.shape[1]
    node_lb = torch.gather(rough_lb, 2, path_k[..., None])[..., 0]
    node_ub = torch.gather(rough_ub, 2, path_k[..., None])[..., 0]

    t = torch.arange(_EXPAND_STEPS, dtype=f32, device=dev)
    base2 = torch.stack([node_ub + _CHECK_S, node_lb - _CHECK_S])  # (2, B, L)
    sign2 = torch.tensor([1.0, -1.0], dtype=f32, device=dev)[:, None, None]
    thr2 = torch.tensor([thr_up, thr_lo], dtype=f32, device=dev)
    cand = base2[..., None] + sign2[..., None] * _CHECK_S * t  # (2, B, L, T)
    within = (sign2[..., None] * cand) < _CHECK_LIMIT
    cx, cy = normal_offset(ref_x[None, ..., None], ref_y[None, ..., None],
                           ref_h[None, ..., None], cand)
    good = maps.is_inside(gm, cx, cy) & \
        (maps.obstacle_distance(gm, cx, cy) > thr2[:, None, None, None])
    fail = within & ~good
    first_fail = torch.argmax(
        torch.cat([fail, torch.ones_like(fail[..., :1])], -1).to(torch.int32),
        dim=-1)
    n_within = torch.sum(within.to(torch.int32), dim=-1)
    exited = first_fail >= n_within
    result_fail = base2 + sign2 * _CHECK_S * (first_fail.to(f32) - 1.0)
    result_exit = base2 + sign2 * _CHECK_S * n_within.to(f32)
    res2 = torch.where(exited, result_exit, result_fail)
    upper, lower = res2[0].clone(), res2[1].clone()
    upper[:, 0] = 10.0
    lower[:, 0] = -10.0
    valid = torch.arange(L, device=dev) <= max_layer[:, None]
    return torch.where(valid, lower, 0.0), torch.where(valid, upper, 0.0)


def finish_corridor(gm: maps.GridMap, lat: DpLattice, costs, parents, alives,
                    config: PlannerConfig) -> Corridor:
    """Backtrack + corridor expansion (:240-287) from a DP forward pass."""
    threshold = config.car_width / 2.0 + 0.2
    max_layer, path_k = _best_path(lat.cost0, costs, parents, alives,
                                   lat.n_layers)
    # Node heading := ref heading per layer (:189); DP thresholds symmetric.
    lower, upper = _expand_corridor(
        gm, lat.ref_x, lat.ref_y, lat.ref_h, lat.rough_lb, lat.rough_ub,
        path_k, max_layer, threshold, threshold)
    return Corridor(layers_s=lat.layers_s, lower=lower, upper=upper,
                    n_layers=max_layer + 1, vehicle_l=lat.vehicle_l,
                    ok=lat.ok)


def _best_path(cost0, costs, parents, alives, n_layers):
    """The deepest reached layer (B,) and the lateral index of each layer
    on the path back from its cheapest node (B, L) (:240-287 / :430-447),
    from layer 0's costs (B, K) and a forward pass's (costs, parents,
    alives) over layers 1 .. L-1."""
    B, K = cost0.shape
    dev = cost0.device
    costs = torch.cat([cost0[:, None], costs], 1)                # (B, L, K)
    parents = torch.cat([torch.zeros((B, 1, K), dtype=parents.dtype,
                                     device=dev), parents], 1)
    alives = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        alives], 1)
    layer = torch.arange(costs.shape[1], device=dev)
    reach = alives & (layer < n_layers[:, None])
    max_layer = torch.amax(torch.where(reach, layer, 0), dim=-1)
    last = torch.gather(costs, 1, max_layer[:, None, None].expand(B, 1, K))
    best_k_last = torch.argmin(last[:, 0], dim=-1)
    return max_layer, _backtrack(parents, max_layer, best_k_last)


def search_corridor(gm: maps.GridMap, xs: splines.CubicSpline,
                    ys: splines.CubicSpline, length, start_x, start_y,
                    start_heading, config: PlannerConfig) -> Corridor:
    """The DP corridor search in one call: lattice, forward pass (K4 on
    CUDA tensors), finish. ``stage_corridor`` calls the three parts
    itself."""
    lat = prepare_lattice(gm, xs, ys, length, start_x, start_y,
                          start_heading, config)
    costs, parents, alives = dp_forward_batched(lat, config)
    return finish_corridor(gm, lat, costs, parents, alives, config)


# The A* search's transition gate, tan(60 deg) (:421): the float32 value
# the JAX package computes, tan(float32(pi / 3)), one ulp above the float32
# nearest sqrt(3).
_TAN60 = 1.732050895690918


def search_corridor_astar(gm: maps.GridMap, xs: splines.CubicSpline,
                          ys: splines.CubicSpline, length, start_x, start_y,
                          start_heading, config: PlannerConfig) -> Corridor:
    """A*-lattice corridor search (graphSearch, :297-484), batched.

    The lattice is the DP search's (:304-347 repeat :148-199). What
    differs, as in the reference:
    - a node is feasible at clearance above 1.2 half-widths (:345), and the
      turn radius clamps the sampled range (:330-339) instead of marking
      nodes infeasible;
    - a node's cost is getG (:91-105): obstacle proximity under a 5 m
      safety distance plus the lateral deviation, no edge term; an edge
      only has to stay within 60 degrees of the layer direction (:421);
    - the corridor widens to 1.3 half-widths of clearance above and 1.2
      below (:458, :471).
    The heuristic is constant within a layer and the lattice is a layered
    DAG, so a relaxation over the layers, in order, gives every node its
    least cost; the JAX package documents the one divergence this fixes
    (the reference's heuristic is not admissible). The relaxation is plain
    tensor code, a loop over the L-1 layers on the whole batch, with ties
    to the smallest parent index (:func:`first_argmin`)."""
    cfg = config
    K = cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    half_width = cfg.car_width * 0.5
    g = _build_lattice_geom(gm, xs, ys, length, start_x, start_y, cfg)
    lat, dis, layers_s = g.lat, g.dis, g.layers_s
    B, L = layers_s.shape
    dev = layers_s.device

    # --- A* feasibility (:330-347) ---
    rr = g.ref_r[..., None]
    in_range = torch.where(rr > 0, lat <= torch.clamp(rr, max=lat_range),
                           lat >= torch.clamp(rr, min=-lat_range))
    # The K-wide grid overshoots +lat_range by up to one spacing step; the
    # reference samples [-range, range] only (:332-339).
    in_range = in_range & (lat <= lat_range)
    feasible = in_range & (dis > 1.2 * half_width)
    rough_lb, rough_ub = _rough_bounds(feasible, lat)

    # --- Node cost, getG (:91-105) ---
    safety = 5.0
    self_cost = torch.where(dis < safety, (safety - dis) / safety
                            * cfg.search_obstacle_cost, 0.0)
    self_cost = self_cost + torch.abs(lat) / lat_range \
        * cfg.search_deviation_cost

    # --- Edge costs (B, L-1, Kp, K): layer 0 is the single start node at
    # the vehicle's offset, so each of its K columns sits there ---
    in_mask = torch.arange(1, L, device=dev) < g.n_layers[:, None]
    feas_in = feasible[:, 1:] & in_mask[..., None]               # (B, L-1, K)
    l_prev = torch.cat([g.vehicle_l[:, None, None].expand(B, 1, K),
                        lat.expand(B, L - 2, K)], 1)             # (B, L-1, Kp)
    edge_ok = (torch.abs(lat[None, None, None, :] - l_prev[..., None])
               <= _TAN60 * (layers_s[:, 1:] - layers_s[:, :-1])[..., None,
                                                                None])
    base_all = torch.where(edge_ok & feas_in[:, :, None, :],
                           self_cost[:, 1:, None, :], _INF)

    # --- Relaxation over the layers (exact least cost) ---
    g_p = torch.zeros((B, K), dtype=torch.float32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    gs, parents, alives = [], [], []
    for layer in range(L - 1):
        best_g, best_prev = first_argmin(g_p[:, :, None] + base_all[:, layer])
        alive = alive & torch.any(best_g < _INF, dim=-1)
        g_p = torch.where(alive[:, None], best_g, _INF)
        gs.append(g_p)
        parents.append(best_prev)
        alives.append(alive)
    g0 = torch.where(torch.arange(K, device=dev) == 0, 0.0, _INF)
    max_layer, path_k = _best_path(
        g0.expand(B, K), torch.stack(gs, 1), torch.stack(parents, 1),
        torch.stack(alives, 1), g.n_layers)
    lower, upper = _expand_corridor(
        gm, g.ref_x, g.ref_y, g.ref_h, rough_lb, rough_ub, path_k, max_layer,
        1.3 * half_width, 1.2 * half_width)
    return Corridor(layers_s=layers_s, lower=lower, upper=upper,
                    n_layers=max_layer + 1, vehicle_l=g.vehicle_l, ok=g.ok)
