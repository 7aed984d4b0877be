"""DP corridor search over the Frenet lattice, batched (port of
``tpu_pathopt.corridor``; reference: graphSearchDp,
reference_path_smoother.cpp:142-295).

Sample a lattice of lateral offsets on longitudinal layers along the smoothed
reference (:func:`prepare_lattice`; :func:`refit_lattice` refits the smoothed
route first; on CUDA tensors both run the nodes as kernel K6,
``csrc/lattice.cu``, beside their plain chain :func:`lattice_nodes_plain`),
run the layer-sequential dynamic program
(:func:`dp_forward`, kernel K4 in ``csrc/dp_forward.cu``, beside its plain
version :func:`dp_forward_plain`), backtrack the cheapest node of the deepest
reachable layer and widen each backtracked node's corridor by ESDF
ray-marching (:func:`finish_corridor`). :func:`search_corridor_astar` is the
reference's A* variant (graphSearch, :297-484) on the same lattice, as plain
tensor code. Every array is batch-leading.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import torch

from tpu_pathopt_torch import kernels, maps, splines
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import const
from tpu_pathopt_torch.geometry import (constrain_angle, global_to_local,
                                        normal_offset)

_INF = 1e30
# How far past the smoothed route's end the corridor reaches, m
# (tension_smoother.cpp:40-41).
ROUTE_EXTENSION = 3.0
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


@dataclasses.dataclass
class LatticeNodes(_LatticeGeom):
    """Everything the DP search computes before its edge costs: the lattice
    geometry, the start node and the DP feasibility rule (K6's outputs)."""

    start_idx: torch.Tensor   # (B,) int64 lateral index of the start node
    feasible: torch.Tensor    # (B, L, K) bool
    rough_lb: torch.Tensor    # (B, L, K)
    rough_ub: torch.Tensor


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


def lattice_nodes_plain(gm: maps.GridMap, xs: splines.CubicSpline,
                        ys: splines.CubicSpline, length, start_x, start_y,
                        config: PlannerConfig) -> LatticeNodes:
    """Layers, vehicle projection, node sampling, the start node, the DP
    feasibility rule and the rough bounds (:148-226) as PyTorch tensor
    code: K6's plain version. Per-scenario inputs are (B,)."""
    cfg = config
    K = cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    g = _build_lattice_geom(gm, xs, ys, length, start_x, start_y, cfg)
    lat, dis = g.lat, g.dis
    start_idx = ((lat_range + g.vehicle_l) / cfg.search_lateral_spacing
                 ).to(torch.int32).long().clamp(0, K - 1)

    # --- DP feasibility rule (:176-205) ---
    threshold = cfg.car_width / 2.0 + 0.2
    rk, rr = g.ref_k[..., None], g.ref_r[..., None]
    radius_bad = ((rk < 0) & (lat < rr)) | ((rk > 0) & (lat > rr))
    feasible = ~(radius_bad | (dis < threshold)) & (lat <= lat_range)
    k_idx = torch.arange(K, device=lat.device)
    # Layer 0: only the start node, forced feasible (:200-205).
    feasible[:, 0] = k_idx == start_idx[:, None]

    # --- Rough per-layer bounds over the lateral axis (:210-226) ---
    rough_lb, rough_ub = _rough_bounds(feasible, lat)
    return LatticeNodes(**vars(g), start_idx=start_idx, feasible=feasible,
                        rough_lb=rough_lb, rough_ub=rough_ub)


def lattice_nodes(gm: maps.GridMap, xs: splines.CubicSpline,
                  ys: splines.CubicSpline, length, start_x, start_y,
                  config: PlannerConfig) -> LatticeNodes:
    """:func:`lattice_nodes_plain` on CPU tensors; on CUDA tensors one
    launch of K6 (:func:`lattice_kernel`), or a ValueError."""
    if kernels.kernel_device(length) is None:
        return lattice_nodes_plain(gm, xs, ys, length, start_x, start_y,
                                   config)
    return lattice_kernel(gm, xs, ys, length, start_x, start_y, config)


def edge_costs(nodes: LatticeNodes, start_heading,
               config: PlannerConfig) -> DpLattice:
    """Every state-independent DP edge cost (:228-238, calculateCostAt)
    and layer 0's costs, from the lattice's nodes."""
    cfg = config
    L, K = cfg.dp_layers, cfg.dp_laterals
    lat_range = cfg.search_lateral_range
    layers_s, n_layers, lat, dis = (nodes.layers_s, nodes.n_layers,
                                    nodes.lat, nodes.dis)
    node_x, node_y, ref_h = nodes.node_x, nodes.node_y, nodes.ref_h
    dev = layers_s.device
    f32 = torch.float32
    safe_dist = cfg.dp_safe_distance
    self_cost = torch.where(dis < safe_dist,
                            (safe_dist - dis) / safe_dist
                            * cfg.dp_weight_obstacle, 0.0)
    self_cost = self_cost + torch.abs(lat) / lat_range * cfg.dp_weight_ref_offset

    in_mask = torch.arange(1, L, device=dev) < n_layers[:, None]
    feas_in = nodes.feasible[:, 1:] & in_mask[..., None]         # (B, L-1, K)
    dir_all = torch.atan2(node_y[:, 1:, None, :] - node_y[:, :-1, :, None],
                          node_x[:, 1:, None, :] - node_x[:, :-1, :, None])
    term2 = torch.abs(constrain_angle(dir_all - ref_h[:, 1:, None, None])) \
        / (math.pi / 2) * cfg.dp_weight_ref_angle_diff
    lat_ok = (torch.abs(lat[None, None, None, :] - lat[None, None, :, None])
              <= (layers_s[:, 1:] - layers_s[:, :-1])[..., None, None])
    base_all = torch.where(lat_ok & feas_in[:, :, None, :],
                           term2 + self_cost[:, 1:, None, :], _INF)

    k_idx = torch.arange(K, device=dev)
    cost0 = torch.where(k_idx == nodes.start_idx[:, None], 0.0, _INF)
    dir0 = start_heading.to(f32)[:, None].expand(-1, K).contiguous()
    return DpLattice(layers_s=layers_s, n_layers=n_layers,
                     vehicle_l=nodes.vehicle_l, ok=nodes.ok,
                     ref_x=nodes.ref_x, ref_y=nodes.ref_y, ref_h=ref_h,
                     rough_lb=nodes.rough_lb, rough_ub=nodes.rough_ub,
                     dir_all=dir_all, base_all=base_all, cost0=cost0,
                     dir0=dir0)


def prepare_lattice(gm: maps.GridMap, xs: splines.CubicSpline,
                    ys: splines.CubicSpline, length, start_x, start_y,
                    start_heading, config: PlannerConfig,
                    mark=None) -> DpLattice:
    """Layers, vehicle projection, node sampling, feasibility, rough bounds
    (:func:`lattice_nodes`: K6 on CUDA tensors) and every state-independent
    DP edge cost (:func:`edge_costs`) (:148-238). Per-scenario inputs are
    (B,). ``mark()``, if given, is called between the nodes and the edge
    costs."""
    nodes = lattice_nodes(gm, xs, ys, length, start_x, start_y, config)
    if mark is not None:
        mark()
    return edge_costs(nodes, start_heading, config)


def refit_lattice_plain(gm: maps.GridMap, x, y, n_valid, start_x, start_y,
                        config: PlannerConfig):
    """``splines.refit`` of the route x, y (B, S) with ``n_valid`` (B,)
    points, extended ROUTE_EXTENSION m past the fit's end, and
    :func:`lattice_nodes_plain` on it: (xs, ys, length, nodes), the plain
    chain of :func:`refit_lattice_kernel`."""
    xs, ys, s_max = splines.refit(x, y, n_valid)
    length = s_max + ROUTE_EXTENSION
    return xs, ys, length, lattice_nodes_plain(gm, xs, ys, length, start_x,
                                               start_y, config)


def refit_lattice(gm: maps.GridMap, x, y, n_valid, start_x, start_y,
                  start_heading, config: PlannerConfig, mark=None):
    """:func:`prepare_lattice` on the smoothed route x, y (B, S) with
    ``n_valid`` (B,) points, refit and extended ROUTE_EXTENSION m past the
    fit's end (tension_smoother.cpp:40-41): (xs, ys, lattice). On CUDA
    tensors the refit and the nodes are one launch of K6
    (:func:`refit_lattice_kernel`), on CPU tensors their plain chain
    (:func:`refit_lattice_plain`). ``mark()``, if given, is called between
    the nodes and the edge costs."""
    refit = (refit_lattice_plain if kernels.kernel_device(x) is None
             else refit_lattice_kernel)
    xs, ys, _, nodes = refit(gm, x, y, n_valid, start_x, start_y, config)
    if mark is not None:
        mark()
    return xs, ys, edge_costs(nodes, start_heading, config)


# --------------------------------- K6 ---------------------------------------

# K6's launch plan (csrc/lattice.cu checks the same limits and formula).
LAT_MAX_SEGMENT_POINTS = 1024
LAT_MAX_LAYERS = 300
LAT_MAX_LATERALS = 300
LAT_MIN_THREADS = 256
LAT_MAX_THREADS = 512


class LatticePlan(NamedTuple):
    threads: int   # a CTA's, one CTA a scenario
    smem: int      # dynamic shared memory bytes


def lattice_plan(S: int, L: int, K: int) -> LatticePlan:
    """K6's launch plan for a route of S points, L layers and K laterals:
    32 ceil(L K / 256) threads within [LAT_MIN_THREADS, LAT_MAX_THREADS]
    (the projection's 256 grid candidates one a thread; about 8 nodes a
    thread below the maximum); 4 (16 S + 6 L + L ceil(K / 32) + 64) bytes
    of shared memory (the route's table and the refit's sweeps, the
    layers' frame, a feasibility bit a node, reductions; at the limits
    85,248 bytes, within a block's 227 KB). Raises ValueError past the
    limits."""
    for what, v, lo, hi in (("segment points", S, 2, LAT_MAX_SEGMENT_POINTS),
                            ("layers", L, 2, LAT_MAX_LAYERS),
                            ("laterals", K, 1, LAT_MAX_LATERALS)):
        if not lo <= v <= hi:
            raise ValueError(f"lattice: {v} {what}, the kernel takes "
                             f"{lo} to {hi}")
    threads = min(LAT_MAX_THREADS, max(LAT_MIN_THREADS, -(-L * K // 256) * 32))
    return LatticePlan(threads, 4 * (16 * S + 6 * L + L * -(-K // 32) + 64))


def lattice_inputs(gm: maps.GridMap, x, y, n_valid, spline, length,
                   start_x, start_y, config: PlannerConfig, device) -> tuple:
    """(plan, inputs): K6's plan (:func:`lattice_plan`) and its input
    tensors in the order of ``kernels.LatticeArgs``, each made contiguous
    (a copy where it is not) and checked to be a float32 (int64 for the
    counts) tensor of its shape on ``device``: the route's points x, y
    (B, S), ``n_valid`` (B,), ``spline`` the 7 tensors s (B, S), x's and
    y's a, b, c (B, S - 1), ``length`` (B,), the start position and the
    map's stencils. Raises ValueError otherwise or past the plan's
    limits."""
    B, S = x.shape
    plan = lattice_plan(S, config.dp_layers, config.dp_laterals)
    f32, i64 = torch.float32, torch.int64
    R, C = gm.esdf.shape
    names = ("s", "xs.a", "xs.b", "xs.c", "ys.a", "ys.b", "ys.c")
    want = ([("x", x, (B, S), f32), ("y", y, (B, S), f32),
             ("n_valid", n_valid, (B,), i64)]
            + [(n, t, (B, S) if n == "s" else (B, S - 1), f32)
               for n, t in zip(names, spline)]
            + [("length", length, (B,), f32), ("start_x", start_x, (B,), f32),
               ("start_y", start_y, (B,), f32),
               ("gm.quad", gm.quad, ((R - 1) * (C - 1), 4), f32)])
    inputs = []
    for name, t, shape, dtype in want:
        t = t.contiguous()
        kernels.expect(name, t, shape, dtype, torch.device(device))
        inputs.append(t)
    return plan, inputs


def _lattice_launch(gm: maps.GridMap, x, y, n_valid, spline, length,
                    start_x, start_y, config: PlannerConfig, refit: bool):
    """One launch of K6 on the current stream, on :func:`lattice_inputs`
    (``spline`` and ``length`` read where ``refit`` is False, else
    written). Returns the LatticeNodes."""
    dev = kernels.kernel_device(x)
    if dev is None:
        raise ValueError("lattice_kernel: CPU tensors take the plain chain")
    plan, inputs = lattice_inputs(gm, x, y, n_valid, spline, length, start_x,
                                  start_y, config, dev)
    cfg = config
    B, S = x.shape
    L, K = cfg.dp_layers, cfg.dp_laterals
    f32, i64 = torch.float32, torch.int64
    layers_s = torch.empty((B, L), dtype=f32, device=dev)
    n_layers = torch.empty((B,), dtype=i64, device=dev)
    vehicle_l = torch.empty((B,), dtype=f32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    start_idx = torch.empty((B,), dtype=i64, device=dev)
    lat = torch.empty((K,), dtype=f32, device=dev)
    ref = torch.empty((5, B, L), dtype=f32, device=dev)
    node = torch.empty((5, B, L, K), dtype=f32, device=dev)
    feasible = torch.empty((B, L, K), dtype=torch.bool, device=dev)
    hx, hy = gm.half_extent
    args = kernels.LatticeArgs(
        *(kernels.ptr(t) for t in inputs + [
            layers_s, n_layers, vehicle_l, ok, start_idx, lat, ref, node,
            feasible]),
        B, S, L, K, gm.n_rows, gm.n_cols, gm.esdf.shape[1],
        cfg.newton_iters, int(refit), 0.5 * gm.n_rows - 0.5,
        0.5 * gm.n_cols - 0.5, 1.0 / gm.resolution, hx, hy, ROUTE_EXTENSION,
        cfg.search_longitudinal_spacing, cfg.search_lateral_spacing,
        1.0 / cfg.search_lateral_spacing, cfg.search_lateral_range,
        cfg.car_width / 2.0 + 0.2)
    kernels.check(kernels.lib().pathopt_lattice(
        ctypes.byref(args), plan.threads, plan.smem,
        kernels.stream_ptr(dev)), "lattice")
    kernels.count_launch("lattice", f"L={L},K={K}")
    ref_x, ref_y, ref_h, ref_k, ref_r = ref
    node_x, node_y, dis, rough_lb, rough_ub = node
    return LatticeNodes(
        layers_s=layers_s, n_layers=n_layers, vehicle_l=vehicle_l, ok=ok,
        lat=lat, ref_x=ref_x, ref_y=ref_y, ref_h=ref_h, ref_k=ref_k,
        ref_r=ref_r, node_x=node_x, node_y=node_y, dis=dis,
        start_idx=start_idx, feasible=feasible, rough_lb=rough_lb,
        rough_ub=rough_ub)


def lattice_kernel(gm: maps.GridMap, xs: splines.CubicSpline,
                   ys: splines.CubicSpline, length, start_x, start_y,
                   config: PlannerConfig) -> LatticeNodes:
    """:func:`lattice_nodes_plain` as one launch of K6
    (``csrc/lattice.cu``) on :func:`lattice_plan`'s plan: the same
    outputs, bit for bit on the card. ``ys`` must share ``xs``'s knots and
    ``n_valid``, as ``splines.fit_xy`` makes them. CPU tensors, and inputs
    of another device, dtype or shape, or past the plan's limits, raise
    ValueError before any launch."""
    return _lattice_launch(gm, xs.y, ys.y, xs.n_valid, (
        xs.s, xs.a, xs.b, xs.c, ys.a, ys.b, ys.c), length, start_x, start_y,
        config, refit=False)


def refit_lattice_kernel(gm: maps.GridMap, x, y, n_valid, start_x, start_y,
                         config: PlannerConfig):
    """:func:`refit_lattice_plain` as one launch of K6: (xs, ys, length,
    nodes), bit for bit the plain chain on the card (xs.y and ys.y are x
    and y, made contiguous). Raises as :func:`lattice_kernel`."""
    x, y = x.contiguous(), y.contiguous()
    dev = kernels.kernel_device(x)
    B, S = x.shape
    f32 = torch.float32
    s = torch.empty((B, S), dtype=f32, device=dev)
    coef = torch.empty((6, B, S - 1), dtype=f32, device=dev)
    length = torch.empty((B,), dtype=f32, device=dev)
    nodes = _lattice_launch(gm, x, y, n_valid, (s, *coef), length, start_x,
                            start_y, config, refit=True)
    xs = splines.CubicSpline(s=s, y=x, a=coef[0], b=coef[1], c=coef[2],
                             n_valid=n_valid)
    ys = splines.CubicSpline(s=s, y=y, a=coef[3], b=coef[4], c=coef[5],
                             n_valid=n_valid)
    return xs, ys, length, nodes


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


# The most laterals K4 takes: one thread of its block for each.
DP_MAX_LATERALS = 1024

# K4's launch plans (csrc/dp_forward.cu checks every plan it is given). Up
# to 119 laterals one CTA a scenario stages each layer's two tables in
# shared memory; past that (or with a cluster size forced) the tables
# stream through a ring of chunks of kp rows, and a scenario may take a
# thread block cluster of CTAs, each streaming a contiguous range of kp.
DP_MAX_SMEM_BYTES = 232448   # 227 KB, the most one block can have on the H100
DP_SM_SMEM_BYTES = 233472    # an SM's shared memory; each CTA takes 1 KB more
DP_SMS = 132                 # the H100 SXM's streaming multiprocessors
DP_MAX_CLUSTER = 8           # CTAs of one cluster that every Hopper part runs
DP_MAX_DEPTH = 8             # ring chunks a streamed CTA holds
DP_THREADS = 640             # K x P threads a streamed CTA's slices aim at
DP_CHUNK_BYTES = 16384       # both tables' rows of one chunk, aimed at
DP_LAYER_ROWS = 16           # a layer's fixed cost (barriers, combine) in rows
# What each CTA an SM runs beyond the first adds to a CTA's time: one CTA
# alone does not fill an SM (on the H100, B 256 against B 132 at one CTA a
# scenario took 1.32x at 135 laterals and 1.35x at 300).
DP_SHARED_CTA = 0.33


class DpPlan(NamedTuple):
    """A K4 launch: ``cluster`` CTAs a scenario (CTA rank j scans kp rows
    [j ceil(K / cluster), ...)), ``slices`` threads a lateral, ``rows`` kp
    rows a ring chunk, ``depth`` chunks a ring, ``smem`` bytes of shared
    memory a CTA; ``staged``: one CTA with two layers' tables in shared
    memory (``rows`` K, ``depth`` 2)."""
    cluster: int
    slices: int
    rows: int
    depth: int
    smem: int
    staged: bool


def dp_staged_plan(K: int) -> DpPlan | None:
    """The staged plan at K laterals, or None where two layers' tables do
    not fit in one CTA's shared memory (K > 119): P slices of the kp scan
    with K x P about 256 and no slice empty, and shared memory for 4 K^2
    floats of tables, the frontier and the P partial minima."""
    slices = min(K, 256 // K if K < 256 else 1)
    size = -(-K // slices)
    slices = -(-K // size)
    smem = 4 * (4 * K * K + 2 * K + 2 * slices * K)
    return DpPlan(1, slices, K, 2, smem, True) \
        if smem <= DP_MAX_SMEM_BYTES else None


def dp_smem_bytes(K: int, cluster: int, rows: int, depth: int) -> int:
    """Shared memory of a streamed CTA: ``depth`` ring slots, each two table
    regions of rows x K floats rounded up to 16 bytes and 16 more (a
    chunk keeps its source's offset within 16 bytes) and two mbarriers;
    the frontier (cost and direction) twice over; in a cluster the CTA's
    partial minima (cost, kp, direction) twice over."""
    region = -(-rows * K // 4) * 4 + 4
    return 4 * (depth * (2 * region + 4) + 4 * K
                + (6 * K if cluster > 1 else 0))


def dp_held(K: int, plan: DpPlan) -> int:
    """How many clusters (CTAs where ``plan.cluster`` is 1) of a streamed
    plan the card holds at once, as a model: DP_SMS SMs, each holding as
    many CTAs as its threads (2048) and shared memory allow. The card's
    own count (``dp_card_plan``) also knows how its SMs group into GPCs,
    which a cluster may not span."""
    threads = -(-K * plan.slices // 32) * 32
    per_sm = min(2048 // threads, DP_SM_SMEM_BYTES // (plan.smem + 1024))
    return DP_SMS * per_sm // plan.cluster


def _streamed_plan(B: int, K: int, c: int, slices: int) -> DpPlan:
    """The streamed plan in clusters of c: chunks of DP_CHUNK_BYTES of rows
    (a multiple of P, at most a CTA's rows); as many chunks a ring, up to
    DP_MAX_DEPTH and at least 2, as keep the CTAs an SM is given (ceil(B c
    / DP_SMS), as far as its threads allow) within its shared memory."""
    kr = -(-K // c)
    threads = -(-K * slices // 32) * 32
    rows = min(kr, max(slices, DP_CHUNK_BYTES // (8 * K) // slices * slices))
    resident = max(1, min(-(-B * c // DP_SMS), 2048 // threads))
    budget = min(DP_MAX_SMEM_BYTES, DP_SM_SMEM_BYTES // resident - 1024)
    depth = DP_MAX_DEPTH
    while depth > 2 and dp_smem_bytes(K, c, rows, depth) > budget:
        depth -= 1
    return DpPlan(c, slices, rows, depth, dp_smem_bytes(K, c, rows, depth),
                  False)


def dp_plan(B: int, K: int, cluster: int | None = None,
            held=dp_held) -> DpPlan:
    """K4's launch plan for B scenarios of K laterals.

    The staged plan where it fits and no cluster size is forced; else the
    streamed one: P, the largest power of two (at most 32) with K x P at
    most DP_THREADS (1 past that), threads a lateral; c CTAs a scenario,
    exactly ``cluster``, or the c in 1..DP_MAX_CLUSTER with no CTA empty
    that takes the least time on the busiest SM: ceil(B / h) waves, h =
    ``held(K, plan)`` (the clusters the card holds at once), each with s =
    ceil(min(B, h) c / DP_SMS) CTAs on an SM, which take 1 +
    DP_SHARED_CTA (s - 1) times one CTA's ceil(K / c) rows plus
    DP_LAYER_ROWS for a layer's barriers; the smallest c among equals.
    ValueError for K outside 1 .. DP_MAX_LATERALS or a cluster size with
    no plan."""
    if B < 1 or not 1 <= K <= DP_MAX_LATERALS:
        raise ValueError(f"dp_plan: B={B}, K={K}; K4 takes 1 to "
                         f"{DP_MAX_LATERALS} laterals")
    if cluster is None:
        staged = dp_staged_plan(K)
        if staged is not None:
            return staged
    slices = 1
    while slices < 32 and 2 * slices * K <= DP_THREADS:
        slices *= 2
    best = None
    for c in [cluster] if cluster is not None else range(
            1, DP_MAX_CLUSTER + 1):
        if not 1 <= c <= DP_MAX_CLUSTER or (c - 1) * -(-K // c) >= K:
            continue
        plan = _streamed_plan(B, K, c, slices)
        if cluster is not None:
            return plan
        h = held(K, plan)
        if h < 1:
            continue
        shared = -(-min(B, h) * c // DP_SMS) - 1
        cost = -(-B // h) * (1 + DP_SHARED_CTA * shared) * (
            -(-K // c) + DP_LAYER_ROWS)
        if best is None or cost < best[0]:
            best = (cost, plan)
    if best is None:
        raise ValueError(f"dp_plan: K={K} has no plan in clusters of "
                         f"{cluster} (1 to {DP_MAX_CLUSTER} CTAs, none "
                         "without rows)")
    return best[1]


# (device, K, plan) -> clusters of the plan the card holds at once.
_HELD: dict = {}


def _card_held(K: int, plan: DpPlan) -> int:
    key = (torch.cuda.current_device(), K) + tuple(plan)
    if key not in _HELD:
        held = ctypes.c_int()
        kernels.check(kernels.lib().pathopt_dp_resident(
            K, plan.cluster, plan.slices, plan.rows, plan.depth, plan.smem,
            ctypes.byref(held)), "dp_forward (occupancy)")
        _HELD[key] = held.value
    return _HELD[key]


def dp_card_plan(B: int, K: int, cluster: int | None = None) -> DpPlan:
    """:func:`dp_plan` weighing the cluster sizes by what the current CUDA
    card holds at once (the CUDA runtime's occupancy count, once a plan): the
    plan :func:`dp_forward` launches."""
    return dp_plan(B, K, cluster, held=_card_held)


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
    half_pi = const(math.pi / 2, dtype=torch.float32, device=dev)
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


def dp_forward(dir_all, base_all, h_in, cost0, dir0, w1: float,
               _cluster=None):
    """The DP forward pass (K4, ``csrc/dp_forward.cu``), same arguments and
    results as :func:`dp_forward_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, on
    :func:`dp_card_plan`'s plan (``_cluster`` forces the streamed plan in
    clusters of that size, for tests of the cluster path). A lattice of
    more than ``DP_MAX_LATERALS`` (1024) laterals, or a cluster size with
    no plan, raises ValueError before any launch; a plan or cluster the
    card refuses raises RuntimeError."""
    dev = kernels.kernel_device(dir_all)
    if dev is None:
        return dp_forward_plain(dir_all, base_all, h_in, cost0, dir0, w1)
    B, lm1, Kp, K = dir_all.shape
    if Kp != K:
        raise ValueError(f"dp_forward: lattice ({Kp}, {K}), the kernel takes "
                         "a square lattice")
    if K > DP_MAX_LATERALS:
        raise ValueError(f"dp_forward: {K} laterals, the kernel takes at "
                         f"most {DP_MAX_LATERALS}")
    f32 = torch.float32
    for name, t, shape in (("dir_all", dir_all, (B, lm1, K, K)),
                           ("base_all", base_all, (B, lm1, K, K)),
                           ("h_in", h_in, (B, lm1)), ("cost0", cost0, (B, K)),
                           ("dir0", dir0, (B, K))):
        kernels.expect(name, t, shape, f32, dev)
    plan = dp_card_plan(B, K, cluster=_cluster)
    costs = torch.empty((B, lm1, K), dtype=f32, device=dev)
    parents = torch.empty((B, lm1, K), dtype=torch.int32, device=dev)
    alives = torch.empty((B, lm1), dtype=torch.uint8, device=dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_dp_forward(
        p(dir_all), p(base_all), p(h_in), p(cost0), p(dir0), p(costs),
        p(parents), p(alives), B, lm1, K, int(plan.staged), plan.cluster,
        plan.slices, plan.rows, plan.depth, plan.smem, float(w1),
        kernels.stream_ptr(dev))
    kernels.check(err, "dp_forward")
    kernels.count_launch("dp_forward", f"K={K},c={plan.cluster}")
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
    sign2 = const([1.0, -1.0], dtype=f32, device=dev)[:, None, None]
    thr2 = const([thr_up, thr_lo], dtype=f32, device=dev)
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
