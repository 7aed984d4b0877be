"""The planner's settings, as the plain reference reads them.

A frozen copy of the fields of ``PlannerConfig`` (the reference's
``planning_flags.cpp`` defaults and the port's static shapes), so that a
later change to the program cannot move what the reference computes. It
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    # --- Car geometry (reference: planning_flags.cpp:10-22) ---
    car_width: float = 2.0
    car_length: float = 4.9
    safety_margin: float = 0.3          # mandatory margin in bound extraction
    wheel_base: float = 2.5
    rear_length: float = -1.0           # rear axle to rear edge (signed, along heading)
    front_length: float = 3.9           # rear axle to front edge
    max_steering_angle: float = 35.0 * math.pi / 180.0

    # --- Smoothing (planning_flags.cpp:27-67) ---
    smoothing_method: str = "TENSION2"  # "TENSION" | "TENSION2"
    search_lateral_range: float = 10.0
    search_longitudinal_spacing: float = 1.5
    search_lateral_spacing: float = 0.6
    cartesian_curvature_weight: float = 1.0
    cartesian_curvature_rate_weight: float = 50.0
    cartesian_deviation_weight: float = 0.0
    tension_2_deviation_weight: float = 0.005
    tension_2_curvature_weight: float = 1.0
    tension_2_curvature_rate_weight: float = 10.0
    search_obstacle_cost: float = 0.4
    search_deviation_cost: float = 0.4
    # Corridor search variant: "DP" (graphSearchDp, the reference's live
    # path) or "ASTAR" (graphSearch).
    corridor_method: str = "DP"

    # --- DP corridor search weights (reference_path_smoother.cpp:113-117) ---
    dp_weight_ref_offset: float = 1.0
    dp_weight_obstacle: float = 0.5
    dp_weight_angle_change: float = 16.0
    dp_weight_ref_angle_diff: float = 0.5
    dp_safe_distance: float = 3.0

    # --- Post-smoothing QP weights (reference_path_smoother.cpp:587-589) ---
    post_weight_l: float = 1.0
    post_weight_dl: float = 100.0
    post_weight_ddl: float = 1000.0

    # --- Path QP weights (base_solver.cpp:123-126) ---
    weight_l: float = 0.0
    weight_kappa: float = 20.0
    weight_dkappa: float = 100.0
    weight_slack: float = 10.0
    expected_safety_margin: float = 0.6  # soft shrink of collision corridor
    constraint_end_heading: bool = True

    # --- Output / discretization (planning_flags.cpp:106-114) ---
    output_spacing: float = 0.3
    epsilon: float = 1e-6
    # Newton projection iteration cap (the reference hardcodes 20).
    newton_iters: int = 12
    # Directional-projection grid pre-scan fallback in bound extraction.
    # Off by default, as in the reference mainline.
    directional_prescan_fallback: bool = False
    # Curvature-adaptive resampling (reference_path_impl.cpp:321-335).
    enable_dynamic_segmentation: bool = True
    rough_constraints_far_away: bool = False
    precise_planning_length: float = 30.0

    # --- Static shapes ---
    n_knots: int = 128          # max path-QP horizon
    n_segment_points: int = 64  # max points for the smoothing QPs (@1 m spacing)
    dp_layers: int = 32         # max DP longitudinal layers
    dp_laterals: int = 35       # lateral samples: 2*10/0.6 + 1 -> 35
    bspline_samples: int = 256  # max raw B-spline samples (@ ~1 m)

    # --- QP solver settings (base_solver.cpp:59-62) ---
    qp_eps_abs: float = 2e-3
    qp_eps_rel: float = 2e-3
    qp_max_iter: int = 4000
    qp_check_every: int = 25

    def __post_init__(self):
        if self.smoothing_method not in ("TENSION", "TENSION2"):
            raise ValueError(
                f"smoothing_method must be 'TENSION' or 'TENSION2', "
                f"got {self.smoothing_method!r}")
        if self.corridor_method not in ("DP", "ASTAR"):
            raise ValueError(
                f"corridor_method must be 'DP' or 'ASTAR', "
                f"got {self.corridor_method!r}")

    @property
    def kappa_limit(self) -> float:
        # base_solver.cpp:226
        return math.tan(self.max_steering_angle) / self.wheel_base
