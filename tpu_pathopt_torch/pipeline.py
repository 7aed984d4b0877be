"""End-to-end batched path optimization pipeline (port of
``tpu_pathopt.pipeline``; reference: PathOptimizer::solve,
path_optimizer.cpp:34-71):

    raw points -> B-spline fit -> 1 m segmentation -> TENSION2 (or TENSION)
    smoothing QP -> DP (or A*) corridor search -> post-smoothing QP
    -> 0.3 m resampling -> ESDF collision bounds -> two-pass lateral path QP
    -> SlState path

Every stage works on the whole scenario batch at once (the JAX package's
``vmap`` written out as a leading batch axis). Stage failures follow the
reference's abort semantics but are reported as flags on the result.

Entry points: :func:`solve_batch`, :func:`solve` and
:func:`solve_batch_warm` (one replanning solve, warm-started from a
:class:`QPWarmStart`), which issue every operation from the host; the
compiled :func:`solve_batch_jit` and :func:`solve_jit`, which replay the
CUDA graph captured on their first call; and :func:`solve_batch_profiled`
(per-stage timing), each stage a compiled call of its own.
Each runs on ``cuda`` unless the caller passes another device; with no GPU
and no explicit device it raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from tpu_pathopt_torch import bounds as bounds_mod
from tpu_pathopt_torch import (bspline, corridor, kernels, maps, profiling,
                               refpath, splines)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import (constrain_angle, global_to_local,
                                        normal_offset)
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.refpath import CorridorBounds
from tpu_pathopt_torch.smoothing.post_smooth import post_smooth_batched
from tpu_pathopt_torch.smoothing.segment import segment_raw_reference
from tpu_pathopt_torch.smoothing.tension import tension_smooth_batched
from tpu_pathopt_torch.smoothing.tension2 import tension2_smooth_batched
from tpu_pathopt_torch.solver.assembly import assemble_path_qp
from tpu_pathopt_torch.solver.path_solver import (path_setup, path_solution,
                                                  solve_path)
from tpu_pathopt_torch.torchutil import (EAGER, SegmentCache, compiled,
                                         resolve_device, take, to_device,
                                         tree_map)


@dataclasses.dataclass
class Scenario:
    """Queries: raw reference points + start/target states, batch-leading
    (a single query has no batch axis; see :func:`solve`)."""

    raw_x: torch.Tensor         # (B, R) padded raw reference points
    raw_y: torch.Tensor
    n_raw: torch.Tensor         # (B,) int64
    start_x: torch.Tensor       # (B,)
    start_y: torch.Tensor
    start_heading: torch.Tensor
    start_k: torch.Tensor
    target_x: torch.Tensor
    target_y: torch.Tensor
    target_heading: torch.Tensor


@dataclasses.dataclass
class PathResult:
    """Optimized SlState paths (data_struct.hpp:28-32 + getOptimizedPath,
    base_solver.cpp:263-288), batch-leading."""

    x: torch.Tensor             # (B, N)
    y: torch.Tensor
    heading: torch.Tensor
    l: torch.Tensor
    d_heading: torch.Tensor
    k: torch.Tensor
    d_k: torch.Tensor
    s: torch.Tensor
    n_valid: torch.Tensor       # (B,) int64
    ok: torch.Tensor            # (B,) bool: full-pipeline success
    blocked: torch.Tensor       # horizon truncated at an obstacle
    qp_iters: torch.Tensor      # total ADMM iterations (both passes)
    ok_input: torch.Tensor      # >= 4 raw points
    ok_smooth: torch.Tensor     # smoothing QP converged
    ok_corridor: torch.Tensor   # vehicle near the reference
    ok_post: torch.Tensor       # post-smoothing QP (>= 4 layers + converged)
    ok_init: torch.Tensor       # initial heading error <= 75 deg
    ok_qp: torch.Tensor         # both path-QP passes converged
    horizon_truncated: torch.Tensor
    bounds: CorridorBounds

    @property
    def mask(self):
        n = self.x.shape[-1]
        return torch.arange(n, device=self.x.device) < self.n_valid[..., None]


# ------------------------------ pipeline stages ------------------------------
#
# Each stage runs its straight-line code as segments of ``drv`` (a
# ``torchutil.Segments``) and its QP rounds as ``drv.loop``: eagerly by
# default, captured into one CUDA graph by the compiled entry points. Every
# tensor operation of a stage lies inside one of its segments; between them
# the eager path only reads the QP rounds' flags.

def _prep(scs: Scenario, config: PlannerConfig):
    """The prep stage: K7 (:func:`prep_kernel`) on CUDA tensors, the plain
    chain (:func:`_prep_plain`) on CPU tensors."""
    if kernels.kernel_device(scs.raw_x) is None:
        return _prep_plain(scs, config)
    return prep_kernel(scs, config)


def _prep_plain(scs: Scenario, config: PlannerConfig):
    """The prep stage as PyTorch tensor code, K7's plain version:
    (ok_input, x, y, s, angle, k, n_valid)."""
    ok_input = scs.n_raw >= 4
    xb, yb, sb, nb = bspline.fit_and_sample(scs.raw_x, scs.raw_y, scs.n_raw,
                                            config.bspline_samples)
    return (ok_input,) + segment_raw_reference(xb, yb, sb, nb,
                                               config.n_segment_points)


# K7's launch plan (csrc/prep.cu checks the same limits and formula). At
# 128 raw segments PyTorch's CUDA sum, whose order K7 follows, changes it.
PREP_MAX_RAW = 128
PREP_MAX_SAMPLES = 1024
PREP_MAX_POINTS = 1024
PREP_MAX_THREADS = 512


class PrepPlan(NamedTuple):
    threads: int   # a CTA's, one CTA a scenario
    smem: int      # dynamic shared memory bytes


def prep_plan(R: int, T: int, P: int) -> PrepPlan:
    """K7's launch plan for R raw points, T B-spline samples and P segment
    points: max(T, P) threads rounded up to a warp, at most
    PREP_MAX_THREADS (one sample, then one station, a thread); 4 (16 T +
    2 R) bytes of shared memory (the samples' spline table and the fit's
    sweeps, the raw points; at the limits 66,560 bytes, within a block's
    227 KB). Raises ValueError past the limits."""
    for what, v, lo, hi in (("raw points", R, 2, PREP_MAX_RAW),
                            ("B-spline samples", T, 2, PREP_MAX_SAMPLES),
                            ("segment points", P, 1, PREP_MAX_POINTS)):
        if not lo <= v <= hi:
            raise ValueError(f"prep: {v} {what}, the kernel takes "
                             f"{lo} to {hi}")
    threads = min(PREP_MAX_THREADS, -(-max(T, P) // 32) * 32)
    return PrepPlan(threads, 4 * (16 * T + 2 * R))


def prep_inputs(scs: Scenario, config: PlannerConfig, device) -> tuple:
    """(plan, inputs): K7's plan (:func:`prep_plan`) and its input tensors
    in the order of ``kernels.PrepArgs`` (raw_x, raw_y (B, R) float32,
    n_raw (B,) int64), each made contiguous (a copy where it is not) and
    checked to be of its dtype and shape on ``device``; raises ValueError
    otherwise or past the plan's limits."""
    B, R = scs.raw_x.shape
    plan = prep_plan(R, config.bspline_samples, config.n_segment_points)
    want = (("raw_x", scs.raw_x, (B, R), torch.float32),
            ("raw_y", scs.raw_y, (B, R), torch.float32),
            ("n_raw", scs.n_raw, (B,), torch.int64))
    inputs = []
    for name, t, shape, dtype in want:
        t = t.contiguous()
        kernels.expect(name, t, shape, dtype, torch.device(device))
        inputs.append(t)
    return plan, inputs


def prep_kernel(scs: Scenario, config: PlannerConfig):
    """:func:`_prep_plain` as one launch of K7 (``csrc/prep.cu``) on the
    current stream, on :func:`prep_plan`'s plan: the same outputs, bit for
    bit on the card. CPU tensors, and inputs that :func:`prep_inputs`
    refuses, raise ValueError before any launch."""
    dev = kernels.kernel_device(scs.raw_x)
    if dev is None:
        raise ValueError("prep_kernel: CPU tensors take _prep_plain")
    plan, inputs = prep_inputs(scs, config, dev)
    B, R = scs.raw_x.shape
    T, P = config.bspline_samples, config.n_segment_points
    ok_input = torch.empty((B,), dtype=torch.bool, device=dev)
    out = torch.empty((5, B, P), dtype=torch.float32, device=dev)
    n_valid = torch.empty((B,), dtype=torch.int64, device=dev)
    args = kernels.PrepArgs(
        *(kernels.ptr(t) for t in inputs + [ok_input, out, n_valid]),
        B, R, T, P)
    kernels.check(kernels.lib().pathopt_prep(
        ctypes.byref(args), plan.threads, plan.smem,
        kernels.stream_ptr(dev)), "prep")
    kernels.count_launch("prep", f"R={R},T={T},P={P}")
    x, y, s, angle, k = out
    return ok_input, x, y, s, angle, k, n_valid


def stage_prep(scs: Scenario, config: PlannerConfig, drv=EAGER):
    """B-spline fit (reference_path_smoother.cpp:490-524) + 1 m
    segmentation (:47-85); on the card one K7 launch."""
    return drv("prep", functools.partial(_prep, config=config), scs)


def stage_smooth(gm: maps.GridMap, prep_out, config: PlannerConfig,
                 settings: QPSettings, stats: dict | None = None, drv=EAGER):
    """Smoothing QP: TENSION2 (the default, tension_smoother_2.cpp:20-72)
    or TENSION (tension_smoother.cpp, whose clearance bounds read the
    map)."""
    ok_input, xg, yg, sg, ang, kg, n_seg = prep_out
    if config.smoothing_method == "TENSION2":
        return tension2_smooth_batched(xg, yg, ang, kg, sg, n_seg, config,
                                       settings, stats=stats, drv=drv)
    return tension_smooth_batched(gm, xg, yg, ang, n_seg, config, settings,
                                  stats=stats, drv=drv)


def _corridor(gm: maps.GridMap, scs: Scenario, smooth_out,
              config: PlannerConfig, trace=None):
    """The corridor stage. ``trace``, a traced runner (``profiling``),
    stamps the DP search's parts (:data:`profiling.CORRIDOR_STAMPS`: the
    edge costs, K4, the finish) and notes the lattice's work."""
    x2, y2, s2, n2, ok_smooth = smooth_out
    if config.corridor_method == "ASTAR":
        xs2, ys2, s2_max = splines.refit(x2, y2, n2)
        cor = corridor.search_corridor_astar(
            gm, xs2, ys2, s2_max + corridor.ROUTE_EXTENSION, scs.start_x,
            scs.start_y, scs.start_heading, config)
        return xs2, ys2, cor
    edges, dp, finish = profiling.CORRIDOR_STAMPS
    stamp = trace.stamp if trace is not None else (lambda name: None)
    xs2, ys2, lat = corridor.refit_lattice(
        gm, x2, y2, n2, scs.start_x, scs.start_y, scs.start_heading, config,
        mark=functools.partial(stamp, edges))
    if trace is not None:
        b, lm1, kp, k = lat.dir_all.shape
        trace.work["lattice"] = dict(
            edges=b * lm1 * kp * k, shape=[b, lm1, k],
            table_bytes=sum(t.numel() * t.element_size()
                            for t in (lat.dir_all, lat.base_all)))
    stamp(dp)
    costs, parents, alives = corridor.dp_forward_batched(lat, config)
    stamp(finish)
    cor = corridor.finish_corridor(gm, lat, costs, parents, alives, config)
    return xs2, ys2, cor


def stage_corridor(gm: maps.GridMap, scs: Scenario, smooth_out,
                   config: PlannerConfig, drv=EAGER):
    """Smoothed-spline refit + corridor search, on a spline extended 3 m
    past the fit (tension_smoother.cpp:40-41): the DP search
    (graphSearchDp, :142-295; on the card the refit and its lattice are
    K6, its forward pass K4) or, with ``corridor_method="ASTAR"``, the A*
    lattice search (graphSearch, :297-484, plain tensor code)."""
    return drv("corridor", functools.partial(
        _corridor, config=config, trace=drv if drv.traced else None), gm,
        scs, smooth_out)


def stage_post_smooth(cor, config: PlannerConfig, settings: QPSettings,
                      stats: dict | None = None, drv=EAGER):
    """Post-smoothing QP (postSmooth, :526-580)."""
    l_post, post_ok, conv_post = post_smooth_batched(
        cor.layers_s, cor.lower, cor.upper, cor.vehicle_l, cor.n_layers,
        config, settings, stats=stats, drv=drv)
    return l_post, drv("post.ok", torch.logical_and, post_ok, conv_post)


def _geometry(gm: maps.GridMap, scs: Scenario, xs2, ys2, cor, l_post,
              config: PlannerConfig):
    """The geometry stage: K5 (:func:`geometry_kernel`) on CUDA tensors,
    the plain chain (:func:`_geometry_plain`) on CPU tensors."""
    if kernels.kernel_device(l_post) is None:
        return _geometry_plain(gm, scs, xs2, ys2, cor, l_post, config)
    return geometry_kernel(gm, scs, xs2, ys2, cor, l_post, config)


def _geometry_plain(gm: maps.GridMap, scs: Scenario, xs2, ys2, cor, l_post,
                    config: PlannerConfig):
    """The geometry stage as PyTorch tensor code, K5's plain version."""
    cfg = config
    ref_dir = splines.heading(xs2, ys2, cor.layers_s)
    x3, y3 = normal_offset(splines.evaluate(xs2, cor.layers_s),
                           splines.evaluate(ys2, cor.layers_s), ref_dir,
                           l_post)
    xs3, ys3, length3 = splines.refit(x3, y3, cor.n_layers)

    # Init state (processInitState, path_optimizer.cpp:73-85).
    zero = torch.zeros_like(length3)
    ix = splines.evaluate(xs3, zero)
    iy = splines.evaluate(ys3, zero)
    ih = splines.heading(xs3, ys3, zero)
    _, local_y, _ = global_to_local(scs.start_x, scs.start_y,
                                    scs.start_heading, ix, iy)
    min_dist = torch.hypot(ix - scs.start_x, iy - scs.start_y)
    init_offset = torch.where(local_y < 0.0, min_dist, -min_dist)
    init_heading_error = constrain_angle(scs.start_heading - ih)
    ok_init = torch.abs(init_heading_error) <= 75.0 * torch.pi / 180.0

    # Trim to the target projection (setReferencePathLength, :87-103).
    ex = splines.evaluate(xs3, length3)
    ey = splines.evaluate(ys3, length3)
    eh = splines.heading(xs3, ys3, length3)
    local_tx, _, _ = global_to_local(ex, ey, eh, scs.target_x, scs.target_y)
    proj_s = splines.project(xs3, ys3, scs.target_x, scs.target_y, length3,
                             iters=cfg.newton_iters)
    length3 = torch.where(local_tx > 0.0, length3, proj_s)

    # Resample at output spacing (buildReferenceFromSpline).
    ref = refpath.build_reference_from_spline(xs3, ys3, length3,
                                              cfg.n_knots, cfg)
    # Collision bounds + blocked truncation (updateBoundsImproved).
    cb = bounds_mod.update_bounds(gm, xs3, ys3, ref, cfg,
                                  with_center=cfg.rough_constraints_far_away)
    n_valid = torch.minimum(ref.n_valid, cb.n_valid)
    ref = dataclasses.replace(ref, n_valid=n_valid)
    return ref, cb, init_offset, init_heading_error, ok_init, n_valid


# K5's launch plan (csrc/geometry.cu checks the same limits and formula).
GEO_MAX_SEGMENT_POINTS = 1024
GEO_MAX_LAYERS = 1024
GEO_MAX_KNOTS = 4096
GEO_MAX_THREADS = 512
GEO_MIN_THREADS = 128


class GeometryPlan(NamedTuple):
    threads: int   # a CTA's, one CTA a scenario
    smem: int      # dynamic shared memory bytes


def geometry_plan(S: int, M: int, N: int) -> GeometryPlan:
    """K5's launch plan for S segment points (the smoothed route's knots),
    M corridor layers and N knots: 2 N threads rounded up to a warp,
    within [GEO_MIN_THREADS, GEO_MAX_THREADS]; 4 (9 S + 16 M + 4 N + 64)
    bytes of shared memory (the two spline tables, the refit's sweeps, the
    knots' states, reductions; at the limits 168,192 bytes, within a
    block's 227 KB). Raises ValueError past the limits."""
    for what, v, lo, hi in (("segment points", S, 2, GEO_MAX_SEGMENT_POINTS),
                            ("corridor layers", M, 2, GEO_MAX_LAYERS),
                            ("knots", N, 1, GEO_MAX_KNOTS)):
        if not lo <= v <= hi:
            raise ValueError(f"geometry: {v} {what}, the kernel takes "
                             f"{lo} to {hi}")
    threads = min(GEO_MAX_THREADS, max(GEO_MIN_THREADS, -(-2 * N // 32) * 32))
    return GeometryPlan(threads, 4 * (9 * S + 16 * M + 4 * N + 64))


def geometry_inputs(gm: maps.GridMap, scs: Scenario, xs2, ys2, cor, l_post,
                    config: PlannerConfig, device) -> tuple:
    """(plan, inputs): K5's plan (:func:`geometry_plan`) and its input
    tensors in the order of ``kernels.GeometryArgs``, each made contiguous
    (a copy where it is not) and checked to be a float32 (int64 for the
    counts) tensor of its shape on ``device``; raises ValueError otherwise
    or past the plan's limits."""
    B, M = l_post.shape
    S = xs2.s.shape[-1]
    plan = geometry_plan(S, M, config.n_knots)
    f32, i64 = torch.float32, torch.int64
    R, C = gm.esdf.shape
    want = {"xs2.s": (xs2.s, (B, S), f32), "xs2.y": (xs2.y, (B, S), f32),
            "xs2.a": (xs2.a, (B, S - 1), f32),
            "xs2.b": (xs2.b, (B, S - 1), f32),
            "xs2.c": (xs2.c, (B, S - 1), f32), "ys2.y": (ys2.y, (B, S), f32),
            "ys2.a": (ys2.a, (B, S - 1), f32),
            "ys2.b": (ys2.b, (B, S - 1), f32),
            "ys2.c": (ys2.c, (B, S - 1), f32),
            "xs2.n_valid": (xs2.n_valid, (B,), i64),
            "cor.layers_s": (cor.layers_s, (B, M), f32),
            "l_post": (l_post, (B, M), f32),
            "cor.n_layers": (cor.n_layers, (B,), i64),
            "start_x": (scs.start_x, (B,), f32),
            "start_y": (scs.start_y, (B,), f32),
            "start_heading": (scs.start_heading, (B,), f32),
            "target_x": (scs.target_x, (B,), f32),
            "target_y": (scs.target_y, (B,), f32),
            "gm.quad": (gm.quad, ((R - 1) * (C - 1), 4), f32)}
    inputs = []
    for name, (t, shape, dtype) in want.items():
        t = t.contiguous()
        kernels.expect(name, t, shape, dtype, torch.device(device))
        inputs.append(t)
    return plan, inputs


def geometry_kernel(gm: maps.GridMap, scs: Scenario, xs2, ys2, cor, l_post,
                    config: PlannerConfig):
    """:func:`_geometry_plain` as one launch of K5 (``csrc/geometry.cu``)
    on the current stream, on :func:`geometry_plan`'s plan: the same
    outputs, bit for bit on the card (the source's note says where not).
    ``ys2`` must share ``xs2``'s knots and ``n_valid``, as
    ``splines.fit_xy`` makes them. CPU tensors, and inputs that
    :func:`geometry_inputs` refuses, raise ValueError before any launch."""
    dev = kernels.kernel_device(l_post)
    if dev is None:
        raise ValueError("geometry_kernel: CPU tensors take _geometry_plain")
    plan, inputs = geometry_inputs(gm, scs, xs2, ys2, cor, l_post, config,
                                   dev)
    B, M = l_post.shape
    S = xs2.s.shape[-1]
    N = config.n_knots
    C = gm.esdf.shape[1]
    f32, i64 = torch.float32, torch.int64
    ref = torch.empty((5, B, N), dtype=f32, device=dev)
    bnd = torch.empty((10, B, N), dtype=f32, device=dev)
    init = torch.empty((2, B), dtype=f32, device=dev)
    n_valid = torch.empty((B,), dtype=i64, device=dev)
    flags = torch.empty((3, B), dtype=torch.bool, device=dev)
    cfg = config
    ds = cfg.output_spacing
    hx, hy = gm.half_extent
    args = kernels.GeometryArgs(
        *(kernels.ptr(t) for t in inputs + [ref, bnd, init, n_valid, flags]),
        B, S, M, N, gm.n_rows, gm.n_cols, C, cfg.newton_iters,
        int(cfg.enable_dynamic_segmentation),
        int(cfg.directional_prescan_fallback),
        int(cfg.rough_constraints_far_away),
        0.5 * gm.n_rows - 0.5, 0.5 * gm.n_cols - 0.5,
        1.0 / gm.resolution, hx, hy, ds, ds - ds / 2.0,
        1.0 / (refpath.LARGE_K - refpath.SMALL_K), 1.0 / ds, (N - 1) * ds,
        cfg.front_length, cfg.rear_length,
        cfg.car_width * 0.5 - bounds_mod.SEARCH_RADIUS, cfg.safety_margin,
        cfg.epsilon, 75.0 * torch.pi / 180.0)
    kernels.check(kernels.lib().pathopt_geometry(
        ctypes.byref(args), plan.threads, plan.smem,
        kernels.stream_ptr(dev)), "geometry")
    kernels.count_launch("geometry", f"M={M},N={N}")
    x, y, heading, k, s = ref
    refs = refpath.RefStates(x=x, y=y, heading=heading, k=k, s=s,
                             n_valid=n_valid, truncated=flags[0])
    cb = CorridorBounds(
        front_lb=bnd[0], front_ub=bnd[1], rear_lb=bnd[2], rear_ub=bnd[3],
        center_lb=bnd[4], center_ub=bnd[5], blocked=flags[1],
        n_valid=n_valid, front_x=bnd[6], front_y=bnd[7], rear_x=bnd[8],
        rear_y=bnd[9], heading=heading)
    return refs, cb, init[0], init[1], flags[2], n_valid


def stage_geometry(gm: maps.GridMap, scs: Scenario, xs2, ys2, cor, l_post,
                   config: PlannerConfig, drv=EAGER):
    """Re-projection, init state, trim, resample, collision bounds
    (processReferencePath, path_optimizer.cpp:105-122)."""
    return drv("geometry", functools.partial(_geometry, config=config), gm,
               scs, xs2, ys2, cor, l_post)


@dataclasses.dataclass
class QPWarmStart:
    """Path-QP solver state carried across repeated solves of an evolving
    query: the persistent OSQP solver object of the reference demo's 30 Hz
    replanning loop (demo.cpp:133-211; OSQP warm-starts from the previous
    solution, base_solver.cpp:97-117). :func:`solve_batch_warm` returns it;
    feed it back on the next solve of the same (advanced) scenarios."""

    v: torch.Tensor          # (B, N, 6) previous pass-2 primal iterate
    y_knot: torch.Tensor     # (B, N, 6) duals (z layout)
    y_end: torch.Tensor      # (B, 2)
    rho_bar: torch.Tensor    # (B,) final adapted rho
    valid: torch.Tensor      # (B,) bool: lanes where False start cold

    @classmethod
    def cold(cls, batch: int, config: PlannerConfig, device=None):
        """A state that seeds every lane cold, on ``device`` (``cuda``
        unless the caller asks for another)."""
        dev = resolve_device(device)
        N = config.n_knots
        z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        return cls(v=z(batch, N, 6), y_knot=z(batch, N, 6),
                   y_end=z(batch, 2), rho_bar=z(batch),
                   valid=torch.zeros(batch, dtype=torch.bool, device=dev))


def build_path_qp(scs: Scenario, geo_out, config: PlannerConfig, sol1=None):
    """Assemble the batched path QP: pass 1 when ``sol1`` is None (zero
    offset/heading error, the reference curvature), else pass 2 linearized
    around pass 1's solution (optimizePath, path_optimizer.cpp:124-161)."""
    ref, cb, init_offset, init_heading_error, ok_init, n_valid = geo_out
    if sol1 is None:
        zeros = torch.zeros_like(ref.k)
        in_l, in_e, in_k = zeros, zeros, ref.k
    else:
        in_l, in_e, in_k = sol1.v[..., 0], sol1.v[..., 1], sol1.v[..., 2]
    return assemble_path_qp(
        ref_s=ref.s, ref_k=ref.k, ref_heading_last=take(ref.heading,
                                                        n_valid - 1),
        input_l=in_l, input_e=in_e, input_k=in_k,
        front_lb=cb.front_lb, front_ub=cb.front_ub,
        rear_lb=cb.rear_lb, rear_ub=cb.rear_ub,
        init_offset=init_offset, init_heading_error=init_heading_error,
        start_k=scs.start_k, target_heading=scs.target_heading,
        blocked=cb.blocked, n_valid=n_valid, config=config,
        center_lb=cb.center_lb, center_ub=cb.center_ub)


def _permute(obj, order):
    """Every batch-leading tensor of ``obj`` reordered by ``order``."""
    return tree_map(lambda a: a[order] if a.dim() else a, obj)


def _qp1_setup(scs: Scenario, geo_out, warm, config: PlannerConfig,
               settings: QPSettings):
    """Pass 1's QP, sorted by expected difficulty, and its solver set up;
    returns (run, inverse order)."""
    ref, cb, init_offset, init_heading_error, ok_init, n_valid = geo_out
    N = config.n_knots
    qp1 = build_path_qp(scs, geo_out, config)
    dtp = qp1.p_diag.dtype
    mask_k = torch.arange(N, device=n_valid.device) < n_valid[:, None]
    width = torch.where(mask_k, torch.minimum(cb.front_ub - cb.front_lb,
                                              cb.rear_ub - cb.rear_lb),
                        torch.inf)
    order1 = torch.argsort(-torch.amin(width, dim=-1), stable=True)
    inv1 = torch.argsort(order1, stable=True)
    rho0 = torch.full(n_valid.shape, settings.rho_bar_path, dtype=dtp,
                      device=n_valid.device)
    seeds = {}
    if warm is not None:
        w = warm.valid
        seeds = dict(
            v0=torch.where(w[:, None, None], warm.v.to(dtp), 0.0)[order1],
            y0_knot=torch.where(w[:, None, None], warm.y_knot.to(dtp),
                                0.0)[order1],
            y0_end=torch.where(w[:, None], warm.y_end.to(dtp), 0.0)[order1])
        rho0 = torch.where(w, warm.rho_bar.to(dtp), rho0)
    run = path_setup(_permute(qp1, order1), settings=settings,
                     rho0=rho0[order1], **seeds)
    return run, inv1


def _qp2_setup(scs: Scenario, geo_out, run1, inv1, config: PlannerConfig,
               settings: QPSettings):
    """Pass 1's solution in the batch's order, and pass 2's QP linearized
    around it, sorted by pass 1's iterations and set up from its state;
    returns (sol1, run, inverse order)."""
    sol1 = _permute(path_solution(run1, 0), inv1)
    qp2 = build_path_qp(scs, geo_out, config, sol1=sol1)
    order = torch.argsort(sol1.iters, stable=True)
    inv = torch.argsort(order, stable=True)
    run = path_setup(_permute(qp2, order), v0=sol1.v[order],
                     y0_knot=sol1.y_knot[order], y0_end=sol1.y_end[order],
                     settings=settings, rho0=sol1.rho_bar[order])
    return sol1, run, inv


def stage_path_qp(scs: Scenario, geo_out, config: PlannerConfig,
                  settings: QPSettings, stats: dict | None = None,
                  warm: QPWarmStart | None = None, drv=EAGER):
    """Two-pass SQP path QP (optimizePath, path_optimizer.cpp:124-161).
    Pass 2 warm-starts from pass 1's (v, y, rho). ``warm`` (optional) seeds
    pass 1 from a previous solve's final state, the replanning warm start:
    lanes where ``warm.valid`` holds start from its (v, y, rho), the others
    from zeros and ``settings.rho_bar_path``, as with ``warm=None``. Both
    passes sort the batch by expected difficulty with a stable sort and
    scatter the results back, as the JAX package does; the sorts are pure
    permutations."""
    run1, inv1 = drv("qp1.setup", functools.partial(
        _qp1_setup, config=config, settings=settings), scs, geo_out, warm)
    run1, rounds1 = solve_path(drv, "qp1", run1, settings)
    sol1, run2, inv = drv("qp2.setup", functools.partial(
        _qp2_setup, config=config, settings=settings), scs, geo_out, run1,
        inv1)
    run2, rounds2 = solve_path(drv, "qp2", run2, settings)
    sol2 = drv("qp2.finish", lambda run, inv: _permute(
        path_solution(run, 0), inv), run2, inv)
    if stats is not None:
        stats["qp1_rounds"] = rounds1
        stats["qp2_rounds"] = rounds2
    return (dataclasses.replace(sol1, rounds=rounds1),
            dataclasses.replace(sol2, rounds=rounds2))


def stage_finalize(ref, sol2, n_valid, config: PlannerConfig):
    """Output path (getOptimizedPath, base_solver.cpp:263-288)."""
    N = config.n_knots
    v = sol2.v
    l, e, k, dk = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x_out, y_out = normal_offset(ref.x, ref.y, ref.heading, l)
    heading_out = constrain_angle(ref.heading + e)
    seg = torch.hypot(torch.diff(x_out, dim=-1), torch.diff(y_out, dim=-1))
    keep = torch.arange(N - 1, device=v.device) <= n_valid[:, None] - 2
    seg = torch.where(keep, seg, 0.0)
    s_out = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, -1)],
                      -1)
    return x_out, y_out, heading_out, l, e, k, dk, s_out


# ------------------------------- entry points --------------------------------

def run_to_geometry(gm: maps.GridMap, scs: Scenario, config: PlannerConfig,
                    settings: QPSettings, stats: dict | None = None,
                    hook=None, drv=EAGER):
    """The stage chain up through ``stage_geometry``. Returns
    ``(geo_out, (ok_input, ok_smooth, cor, ok_post))``. ``hook(name)``, if
    given, is called before each stage, with the names the JAX package's
    ``solve_batch_profiled`` records (``bounds`` before the geometry
    stage)."""
    mark = hook or (lambda name: None)
    mark("prep")
    prep_out = stage_prep(scs, config, drv)
    mark("smooth")
    smooth_out = stage_smooth(gm, prep_out, config, settings, stats, drv)
    mark("corridor")
    xs2, ys2, cor = stage_corridor(gm, scs, smooth_out, config, drv)
    mark("post_smooth")
    l_post, ok_post = stage_post_smooth(cor, config, settings, stats, drv)
    mark("bounds")
    geo_out = stage_geometry(gm, scs, xs2, ys2, cor, l_post, config, drv)
    return geo_out, (prep_out[0], smooth_out[4], cor, ok_post)


def _set_precision():
    """Full float32 products everywhere: the 2e-3 termination tolerance is
    unreachable with TF32 (the JAX package forces "highest" precision for
    the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _finalize(scs: Scenario, geo_out, oks, sol1, sol2, config: PlannerConfig,
              return_warm: bool, tail):
    ok_input, ok_smooth, cor, ok_post = oks
    ref, cb, init_offset, init_heading_error, ok_init, n_valid = geo_out
    ok_qp = sol1.converged & sol2.converged
    x_out, y_out, heading_out, l, e, k, dk, s_out = stage_finalize(
        ref, sol2, n_valid, config)
    ok = ok_input & ok_smooth & cor.ok & ok_post & ok_init & ok_qp
    result = PathResult(
        x=x_out, y=y_out, heading=heading_out, l=l, d_heading=e, k=k, d_k=dk,
        s=s_out, n_valid=n_valid, ok=ok, blocked=cb.blocked,
        qp_iters=sol1.iters + sol2.iters, ok_input=ok_input,
        ok_smooth=ok_smooth, ok_corridor=cor.ok, ok_post=ok_post,
        ok_init=ok_init, ok_qp=ok_qp, horizon_truncated=ref.truncated,
        bounds=cb)
    out = (result,)
    if return_warm:
        # The state for the next solve of the same (advanced) query; lanes
        # whose QP did not converge start cold next time.
        out += (QPWarmStart(v=sol2.v, y_knot=sol2.y_knot, y_end=sol2.y_end,
                            rho_bar=sol2.rho_bar, valid=ok_qp),)
    if tail is not None:
        out += (tail(scs, result),)
    return out[0] if len(out) == 1 else out


def _pipeline(drv, gm: maps.GridMap, scs: Scenario, config: PlannerConfig,
              settings: QPSettings, stats=None, hook=None, warm=None,
              return_warm: bool = False, tail=None):
    """The whole stage chain on inputs already on the device, run as the
    segments of ``drv``. The last segment builds the result (and the warm
    state with ``return_warm``, and ``tail(scs, result)`` if given)."""
    mark = hook or (lambda name: None)
    geo_out, oks = run_to_geometry(gm, scs, config, settings, stats, hook,
                                   drv)
    mark("path_qp")
    sol1, sol2 = stage_path_qp(scs, geo_out, config, settings, stats, warm,
                               drv)
    mark("finalize")
    out = drv("finalize", functools.partial(
        _finalize, config=config, return_warm=return_warm, tail=tail),
        scs, geo_out, oks, sol1, sol2)
    mark("done")
    return out


def solve_batch(gm: maps.GridMap, scenarios: Scenario, config: PlannerConfig,
                settings: QPSettings | None = None, device=None,
                stats: dict | None = None, hook=None) -> PathResult:
    """Solve a batch of scenarios sharing one grid map, on ``device``
    (``cuda`` unless the caller asks for another; the map and scenarios are
    moved there). ``settings=None`` derives the solver settings from the
    config's qp_* fields. Every operation is issued from the host as it
    comes; :func:`solve_batch_jit` replays captured ones.

    ``stats``, if given, receives the batch-global round count of each QP
    (``smooth_rounds``, ``post_rounds``, ``qp1_rounds``, ``qp2_rounds``).
    ``hook(name)``, if given, is called before each stage and with "done"
    at the end (used for per-stage timing)."""
    return _solve_batch_impl(gm, scenarios, config, settings, device, stats,
                             hook)


def _solve_batch_impl(gm: maps.GridMap, scenarios: Scenario,
                      config: PlannerConfig, settings: QPSettings | None,
                      device=None, stats: dict | None = None, hook=None,
                      warm: QPWarmStart | None = None,
                      return_warm: bool = False):
    if settings is None:
        settings = config.qp_settings()
    dev = resolve_device(device)
    _set_precision()
    gm = to_device(gm, dev)
    scs = to_device(scenarios, dev)
    if warm is not None:
        warm = to_device(warm, dev)
    return _pipeline(EAGER, gm, scs, config, settings, stats, hook, warm,
                     return_warm)


def solve_batch_warm(gm: maps.GridMap, scenarios: Scenario,
                     config: PlannerConfig,
                     settings: QPSettings | None = None,
                     warm: QPWarmStart | None = None, device=None):
    """One replanning solve: :func:`solve_batch` with the path QP's pass 1
    seeded from ``warm`` (a previous solve's state; None starts every lane
    cold). Returns ``(PathResult, QPWarmStart)`` for the next cycle. See
    ``replan`` for the streamed loop."""
    return _solve_batch_impl(gm, scenarios, config, settings, device,
                             warm=warm, return_warm=True)


def solve_batch_profiled(gm: maps.GridMap, scenarios: Scenario,
                         config: PlannerConfig,
                         settings: QPSettings | None = None,
                         recorder=None, device=None,
                         stats: dict | None = None) -> PathResult:
    """:func:`solve_batch` with per-stage timing, the reference's
    TimeRecorder instrumentation (path_optimizer.cpp:41-69,
    base_solver.cpp:57-93). Each stage (prep, smooth, corridor,
    post_smooth, the geometry stage under the JAX package's name
    ``bounds``, path_qp, finalize) is its own compiled call, as the JAX
    package jits each (``STAGES``, keyed by the stage, the config, the
    settings and its inputs' signature; its inputs are the previous
    stage's outputs): on CUDA one graph per stage and key, the QP stages'
    rounds WHILE nodes with IF nodes around the refactors, captured on the
    key's first call. ``recorder`` is a ``profiling.TimeRecorder``; before
    each stage it waits for the device to finish the previous one, so a
    stage's time is its replay on the device plus the host's launch and
    the copies between stages, and a first call's times include the
    capture. Without a recorder one is made and its times are logged. The
    same stages run on the same inputs, so the result equals
    :func:`solve_batch`'s bit for bit; the waits and copies between stages
    make the batch slower than :func:`solve_batch_jit`. ``stats``, if
    given, receives each QP's rounds as :func:`solve_batch` gives them,
    read from the device after the call."""
    if settings is None:
        settings = config.qp_settings()
    dev = resolve_device(device)
    _set_precision()
    rec = recorder if recorder is not None else profiling.TimeRecorder(
        "pipeline")
    used = []

    def stage(name, program, *inputs):
        out, segs = compiled(STAGES, (name, config, settings), program,
                             inputs, dev)
        used.append(segs)
        return out

    scs, cfg, st = scenarios, config, settings
    rec.record("prep")
    prep_out = stage("prep", lambda drv, scs: stage_prep(scs, cfg, drv), scs)
    rec.record("smooth", block_on=prep_out)
    smooth_out = stage("smooth", lambda drv, gm, prep_out: stage_smooth(
        gm, prep_out, cfg, st, None, drv), gm, prep_out)
    rec.record("corridor", block_on=smooth_out)
    xs2, ys2, cor = stage("corridor", lambda drv, *a: stage_corridor(
        *a, cfg, drv), gm, scs, smooth_out)
    rec.record("post_smooth", block_on=cor)
    l_post, ok_post = stage("post_smooth", lambda drv, cor: stage_post_smooth(
        cor, cfg, st, None, drv), cor)
    rec.record("bounds", block_on=l_post)
    geo_out = stage("bounds", lambda drv, *a: stage_geometry(*a, cfg, drv),
                    gm, scs, xs2, ys2, cor, l_post)
    rec.record("path_qp", block_on=geo_out)
    sol1, sol2 = stage("path_qp", lambda drv, scs, geo_out: stage_path_qp(
        scs, geo_out, cfg, st, None, None, drv), scs, geo_out)
    rec.record("finalize", block_on=(sol1, sol2))
    oks = (prep_out[0], smooth_out[4], cor, ok_post)
    finish = functools.partial(_finalize, config=cfg, return_warm=False,
                               tail=None)
    result = stage("finalize", lambda drv, *a: drv("finalize", finish, *a),
                   scs, geo_out, oks, sol1, sol2)
    rec.record("done", block_on=result)
    if stats is not None:
        for segs in used:
            stats.update({f"{name}_rounds": n
                          for name, n in segs.sync().items()})
    if recorder is None:
        rec.print_time()
    return result


def solve(gm: maps.GridMap, sc: Scenario, config: PlannerConfig,
          settings: QPSettings | None = None, device=None) -> PathResult:
    """Single-scenario solve: a batch of one through :func:`solve_batch`.
    ``sc`` holds one query without a batch axis; so does the result."""
    scs = tree_map(lambda a: torch.as_tensor(a)[None], sc)
    res = solve_batch(gm, scs, config, settings, device=device)
    return tree_map(lambda a: a[0], res)


# ----------------------------- compiled entry points -------------------------
#
# The counterparts of the JAX package's ``solve_jit`` / ``solve_batch_jit``
# (``jax.jit`` with ``config`` and ``settings`` static). A compiled call runs
# the same stage chain as :func:`solve_batch` through the runner of its
# static key (config, settings, every input's shape and dtype and the map's
# non-tensor fields, whether a warm start is passed, the device;
# ``torchutil.Segments``). On CUDA the key's first call captures the whole
# chain into one CUDA graph, each QP solve's rounds a WHILE node and each
# refactor an IF node inside it, and every call replays that graph: no host
# decision and no host read inside a call, as in the jitted JAX program; a
# failed capture or replay raises, nothing falls back to the eager path. On
# the CPU the same chain runs on every call, each QP round ending in one
# read that stands in for the node's condition. The caller's inputs are
# copied into the key's static buffers on every call, and the results are
# cloned out of the graph's memory, so a later call never changes a result
# already returned. The results are the eager path's, bit for bit: the same
# kernels run on the same values. The QP solvers' round counts and the
# kernels' launch counts stay on the device until asked for (``stats``, or
# ``kernels.sync_counts``): then one read after the call.

COMPILED = SegmentCache(maxsize=16)
# The compiled stages of :func:`solve_batch_profiled` (and the CLI's
# ``run_to_geometry``): a cache of their own, so a profiled run never evicts
# a key of ``COMPILED``.
STAGES = SegmentCache(maxsize=16)


def compiled_call(gm: maps.GridMap, scenarios: Scenario,
                  config: PlannerConfig, settings: QPSettings | None,
                  device=None, stats: dict | None = None,
                  warm: QPWarmStart | None = None, return_warm: bool = False,
                  tail=None, tail_key=None):
    """One compiled call of the stage chain (see above); ``tail`` and
    ``return_warm`` as in :func:`_pipeline`, ``tail_key`` the static
    arguments ``tail`` depends on (part of the cache key). ``stats``, if
    given, receives each QP's rounds as :func:`solve_batch` gives them,
    read from the device after the call. With tracing on
    (``profiling.traced``) the call goes to the key's traced twin, whose
    graph stamps each stage boundary and loop, and records its spans."""
    if settings is None:
        settings = config.qp_settings()
    dev = resolve_device(device)
    _set_precision()

    def program(drv, gm_s, scs_s, warm_s):
        return _pipeline(drv, gm_s, scs_s, config, settings, None,
                         drv.mark if drv.traced else None, warm_s,
                         return_warm, tail)

    key = (config, settings, return_warm, tail_key)
    tracer = profiling.ACTIVE
    if tracer is not None:
        key += ("traced",)
    out, segs = compiled(COMPILED, key, program, (gm, scenarios, warm), dev,
                         tracer)
    if stats is not None:
        stats.update({f"{name}_rounds": n
                      for name, n in segs.sync().items()})
    return out


def last_compiled(traced: bool = False):
    """The key of :func:`compiled_call` called last with tracing on
    (``traced``) or off: (its static arguments ``(config, settings,
    return_warm, tail_key)``, its device, its ``Segments``), or None before
    the first such call."""
    for (key, dev, _), segs in reversed(COMPILED.entries.items()):
        if segs.traced == traced:
            return key[:4], dev, segs
    return None


def solve_batch_jit(gm: maps.GridMap, scenarios: Scenario,
                    config: PlannerConfig, settings: QPSettings | None = None,
                    device=None, stats: dict | None = None) -> PathResult:
    """:func:`solve_batch`, compiled: captured once per static key, then
    replayed (see above). Same arguments and result, bit for bit."""
    return compiled_call(gm, scenarios, config, settings, device, stats)


def solve_jit(gm: maps.GridMap, sc: Scenario, config: PlannerConfig,
              settings: QPSettings | None = None, device=None) -> PathResult:
    """:func:`solve`, compiled: a batch of one through
    :func:`solve_batch_jit`."""
    scs = tree_map(lambda a: torch.as_tensor(a)[None], sc)
    res = solve_batch_jit(gm, scs, config, settings, device=device)
    return tree_map(lambda a: a[0], res)
