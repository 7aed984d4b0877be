"""Reference path containers: sampled states + collision corridor, batched
(port of ``tpu_pathopt.refpath``; reference: reference_path_impl.cpp).

Fixed shapes: every per-knot array is (B, N) with an ``n_valid`` count; the
blocked truncation shortens ``n_valid`` instead of resizing.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pathopt_torch import splines
from tpu_pathopt_torch.config import PlannerConfig

# The curvature ramp of dynamic segmentation: the spacing shrinks toward
# half of it as |k| goes from SMALL_K to LARGE_K (1/m).
SMALL_K, LARGE_K = 0.08, 0.2


@dataclasses.dataclass
class RefStates:
    """Sampled reference states (data_struct.hpp:14-26), batch-leading."""

    x: torch.Tensor          # (B, N)
    y: torch.Tensor
    heading: torch.Tensor
    k: torch.Tensor
    s: torch.Tensor
    n_valid: torch.Tensor    # (B,) int64
    # True when the static N knots did not reach max_s: the end rows then
    # bind at a knot short of the target.
    truncated: torch.Tensor  # (B,) bool

    @property
    def mask(self):
        return (torch.arange(self.x.shape[-1], device=self.x.device)
                < self.n_valid[:, None])


@dataclasses.dataclass
class CorridorBounds:
    """Per-knot lateral corridor at front axle / rear axle / center
    (VehicleStateBound, data_struct.hpp:74-93); lb is the right bound."""

    front_lb: torch.Tensor   # (B, N)
    front_ub: torch.Tensor
    rear_lb: torch.Tensor
    rear_ub: torch.Tensor
    center_lb: torch.Tensor
    center_ub: torch.Tensor
    blocked: torch.Tensor    # (B,) bool: a zero-width bound truncated the horizon
    n_valid: torch.Tensor    # (B,) int64: knots before the blockage
    front_x: torch.Tensor | None = None   # (B, N) axle-center geometry
    front_y: torch.Tensor | None = None
    rear_x: torch.Tensor | None = None
    rear_y: torch.Tensor | None = None
    heading: torch.Tensor | None = None


def build_reference_from_spline(xs: splines.CubicSpline,
                                ys: splines.CubicSpline, max_s,
                                n_knots: int,
                                config: PlannerConfig) -> RefStates:
    """Sample the smoothed splines at ``output_spacing``
    (buildReferenceFromSpline, reference_path_impl.cpp:314-338). With
    dynamic segmentation the spacing shrinks toward half of it where |k|
    ramps through [0.08, 0.2]; the recurrence runs as a loop over the N
    knots, the tail clamped to ``max_s`` and masked by ``n_valid``."""
    ds = config.output_spacing
    max_s = max_s.float()
    dev = max_s.device
    if config.enable_dynamic_segmentation:
        ds_small = ds / 2.0
        tbl = splines.pack_xy(xs, ys)
        s_cur = torch.zeros_like(max_s)
        out = []
        for _ in range(n_knots):
            out.append(s_cur)
            _, _, dx, dy, ddx, ddy = splines.eval_xy_fused(xs, ys, tbl, s_cur)
            k_i = (dx * ddy - dy * ddx) / (dx * dx + dy * dy) ** 1.5
            share = torch.clamp((torch.abs(k_i) - SMALL_K)
                                / (LARGE_K - SMALL_K), 0.0, 1.0)
            s_cur = s_cur + ds - share * (ds - ds_small)
        s = torch.stack(out, dim=-1)
        n_valid = torch.sum(s <= max_s[:, None], dim=-1)
        truncated = s[:, -1] < max_s
    else:
        i = torch.arange(n_knots, dtype=torch.float32, device=dev)
        s = (i * ds).expand(max_s.shape[0], n_knots)
        n_valid = torch.clamp(torch.floor(max_s / ds).long() + 1, max=n_knots)
        truncated = (n_knots - 1) * ds < max_s
    s = torch.minimum(s, max_s[:, None])
    return RefStates(x=splines.evaluate(xs, s), y=splines.evaluate(ys, s),
                     heading=splines.heading(xs, ys, s),
                     k=splines.curvature(xs, ys, s), s=s, n_valid=n_valid,
                     truncated=truncated)
