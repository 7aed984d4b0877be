"""Collision-bound extraction from the ESDF, batched (port of
``tpu_pathopt.bounds``; reference: updateBoundsImproved and
getClearanceWithDirectionStrict, reference_path_impl.cpp:177-312).

For every sampled reference state, march the distance field left and right
along the path normal (0.3 m steps to 6 m, then 0.05 m refinement) to find
the drivable lateral corridor at the front and rear axles, then truncate the
horizon at the first zero-width corridor.
"""

from __future__ import annotations

import math

import torch

from tpu_pathopt_torch import maps, splines
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import global_to_local
from tpu_pathopt_torch.refpath import CorridorBounds, RefStates

_COARSE_DS = 0.3
_FINE_DS = 0.05
SEARCH_RADIUS = 0.5
_COARSE_STEPS = 20        # 6.0 m / 0.3 m
_FINE_STEPS = 5           # int(0.3/0.05) - 1


def _first_true(bad):
    """Index of the first True along the last axis; its length if none."""
    ones = torch.ones_like(bad[..., :1])
    return torch.argmax(torch.cat([bad, ones], -1).to(torch.int32), dim=-1)


def _march(gm: maps.GridMap, x, y, angle, steps: int, ds: float):
    """Number of consecutive steps (positions i*ds, i >= 1) whose clearance
    stays >= the search radius before the first violation."""
    i = torch.arange(1, steps + 1, dtype=torch.float32, device=x.device)
    px = x[..., None] + i * ds * torch.cos(angle)[..., None]
    py = y[..., None] + i * ds * torch.sin(angle)[..., None]
    return _first_true(maps.obstacle_distance(gm, px, py) < SEARCH_RADIUS)


def clearance_strict(gm: maps.GridMap, x, y, heading, config: PlannerConfig):
    """Lateral (left, right) drivable bounds at states of any shape, or
    (0, 0) where the state is in collision or the corridor collapses.

    Like the JAX package, each side is refined along its own direction (the
    reference's right-side refinement probes mirrored positions)."""
    ang2 = torch.stack([heading + math.pi / 2, heading - math.pi / 2])
    ok = maps.obstacle_distance(gm, x, y) > SEARCH_RADIUS

    hits2 = _march(gm, x[None], y[None], ang2, _COARSE_STEPS, _COARSE_DS)
    base2 = torch.where(hits2 < _COARSE_STEPS,
                        hits2.to(torch.float32) * _COARSE_DS,
                        (_COARSE_STEPS - 1) * _COARSE_DS)

    i = torch.arange(1, _FINE_STEPS + 1, dtype=torch.float32, device=x.device)
    step = base2[..., None] + i * _FINE_DS
    px = x[None, ..., None] + step * torch.cos(ang2)[..., None]
    py = y[None, ..., None] + step * torch.sin(ang2)[..., None]
    good = _first_true(maps.obstacle_distance(gm, px, py) < SEARCH_RADIUS)
    ref2 = base2 + torch.clamp(good, max=_FINE_STEPS).to(torch.float32) \
        * _FINE_DS
    left_b, right_b = ref2[0], ref2[1]

    diff_radius = config.car_width * 0.5 - SEARCH_RADIUS
    left = left_b - diff_radius
    right = -(right_b - diff_radius)
    collapsed = left < right

    # Hard safety margin, capped so >= 0.2 m of corridor remains (:304-311).
    max_margin = torch.clamp((left - right - 0.2) / 2.0, min=0.0)
    margin = torch.clamp(max_margin, max=config.safety_margin)
    left = left - margin
    right = right + margin

    invalid = ~ok | collapsed
    return torch.where(invalid, 0.0, left), torch.where(invalid, 0.0, right)


def update_bounds(gm: maps.GridMap, xs: splines.CubicSpline,
                  ys: splines.CubicSpline, ref: RefStates,
                  config: PlannerConfig,
                  with_center: bool = False) -> CorridorBounds:
    """Per-knot corridor at the front/rear axle centers projected onto the
    spline (updateBoundsImproved) + blocked horizon truncation.
    ``with_center`` also fills the center-state corridor."""
    B, N = ref.x.shape
    return _update_bounds_impl(
        gm, xs, ys, ref,
        front_len=torch.full((B, N), config.front_length, device=ref.x.device),
        rear_len=torch.full((B, N), config.rear_length, device=ref.x.device),
        config=config, with_center=with_center)


def update_bounds_on_input_states(gm: maps.GridMap, xs: splines.CubicSpline,
                                  ys: splines.CubicSpline, ref: RefStates,
                                  input_d_heading,
                                  config: PlannerConfig) -> CorridorBounds:
    """Bound re-extraction around a solved path (updateBoundsOnInputStates,
    reference_path_impl.cpp:117-175): :func:`update_bounds` with the axle
    offsets shrunk by the input path's heading error,
    L (1 - cos(d_heading)) (:129-130), and the center corridor always
    extracted (:161). The reference leaves its call commented out
    (path_optimizer.cpp:148); it is an API here, as in the JAX package."""
    one_minus_cos = 1.0 - torch.cos(input_d_heading)
    return _update_bounds_impl(
        gm, xs, ys, ref, front_len=config.front_length * one_minus_cos,
        rear_len=config.rear_length * one_minus_cos, config=config,
        with_center=True)


def _update_bounds_impl(gm, xs, ys, ref: RefStates, front_len, rear_len,
                        config: PlannerConfig,
                        with_center: bool) -> CorridorBounds:
    cfg = config
    # Both axles as one (B, 2, N) projection + clearance chain.
    L = torch.stack([front_len, rear_len], dim=1)
    h = ref.heading[:, None]
    cx = ref.x[:, None] + L * torch.cos(h)
    cy = ref.y[:, None] + L * torch.sin(h)
    # Directional Newton projection of the axle centers onto the spline
    # along the state normal (reference :192-205).
    max_s = (ref.s + 5.0)[:, None].expand_as(L)
    hint = ref.s[:, None] + L
    normal = (ref.heading + math.pi / 2)[:, None].expand_as(L)
    proj_s = splines.project_directional_newton(
        xs, ys, cx, cy, normal, max_s, hint, iters=cfg.newton_iters)
    if cfg.directional_prescan_fallback:
        # A bounded grid pre-scan (getDirectionalProjection, its minimum
        # tracked) rescues a Newton run that diverged from the arc-length
        # hint: keep whichever lands closer to the ray, a non-finite
        # residual counting as infinitely far.
        alt_s = splines.project_directional(
            xs, ys, cx, cy, normal, max_s,
            start_s=torch.clamp(ref.s[:, None].expand_as(L) - 5.0, min=0.0),
            grid=0.5, max_grid_points=21, iters=cfg.newton_iters)
        r_newton, r_alt = (
            torch.nan_to_num(splines.directional_ray_residual(
                xs, ys, cx, cy, normal, s), nan=torch.inf, posinf=torch.inf)
            for s in (proj_s, alt_s))
        proj_s = torch.where(r_alt < r_newton, alt_s, proj_s)
    px = splines.evaluate(xs, proj_s)
    py = splines.evaluate(ys, proj_s)
    # Clearance at the projected points, with the *state* heading (:206).
    left, right = clearance_strict(gm, px, py, h.expand_as(L), cfg)
    # Offset = lateral coordinate of the projected point in the axle frame.
    _, off, _ = global_to_local(cx, cy, h, px, py)
    ub = left + off
    lb = right + off
    front_ub, front_lb = ub[:, 0], lb[:, 0]
    rear_ub, rear_lb = ub[:, 1], lb[:, 1]
    if with_center:
        center_ub, center_lb = clearance_strict(gm, ref.x, ref.y, ref.heading,
                                                cfg)
    else:
        center_ub = torch.zeros_like(front_ub)
        center_lb = torch.zeros_like(front_lb)

    # Blocked detection: zero-width front or rear corridor (:220-229).
    eps = cfg.epsilon
    zero_width = ((torch.abs(front_ub - front_lb) < eps)
                  | (torch.abs(rear_ub - rear_lb) < eps)) & ref.mask
    any_blocked = torch.any(zero_width, dim=-1)
    first_blocked = torch.argmax(zero_width.to(torch.int32), dim=-1)
    n_valid = torch.where(any_blocked,
                          torch.minimum(ref.n_valid, first_blocked),
                          ref.n_valid)
    return CorridorBounds(
        front_lb=front_lb, front_ub=front_ub, rear_lb=rear_lb,
        rear_ub=rear_ub, center_lb=center_lb, center_ub=center_ub,
        blocked=any_blocked, n_valid=n_valid,
        front_x=cx[:, 0], front_y=cy[:, 0], rear_x=cx[:, 1], rear_y=cy[:, 1],
        heading=ref.heading)
