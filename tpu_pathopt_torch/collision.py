"""Vehicle footprint geometry and circle-decomposition collision checks
(port of ``tpu_pathopt.collision``; reference: src/tools/car_geometry.cpp,
six covering circles and one bounding circle, :38-57, and
src/tools/collision_checker.cpp, the bounding-circle test then the exact
six-circle test, :17-59).

The reference builds the checker but never calls it in the pipeline
(collision is enforced through the QP's corridor bounds); it is here for
explicit state checks, e.g. to validate optimized paths afterwards. Every
function is elementwise over any leading batch shape.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_pathopt_torch import maps
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import global_to_local, local_to_global
from tpu_pathopt_torch.torchutil import const, resolve_device, scalar


@dataclasses.dataclass
class CarGeometry:
    """Covering circles in the vehicle frame: centers (C, 2), radii (C,),
    and the bounding circle (center (2,), radius ())."""

    centers: torch.Tensor
    radii: torch.Tensor
    bounding_center: torch.Tensor
    bounding_radius: torch.Tensor


def make_car_geometry(config: PlannerConfig, device=None) -> CarGeometry:
    """Six covering circles (setCircles, car_geometry.cpp:38-57): four
    small corner circles, two large mid circles and a bounding circle, on
    ``device`` (``cuda`` unless the caller asks for another)."""
    dev = resolve_device(device)
    width = config.car_width
    front = config.front_length
    back = abs(config.rear_length)
    length = front + back

    bc_x = (front - back) / 2.0
    bc_r = math.sqrt((length / 2.0) ** 2 + (width / 2.0) ** 2)
    shift = width / 4.0
    small_r = math.sqrt(2.0) * shift
    large_r = math.sqrt(width ** 2 + ((length - width) / 2.0) ** 2) / 2.0

    def f(v):
        return const(v, dtype=torch.float32, device=dev).clone()

    centers = f([
        [-back + shift, -width / 2.0 + shift],    # rr
        [-back + shift, width / 2.0 - shift],     # rl
        [front - shift, -width / 2.0 + shift],    # fr
        [front - shift, width / 2.0 - shift],     # fl
        [bc_x + (length - width) / 4.0, 0.0],     # fm
        [bc_x - (length - width) / 4.0, 0.0],     # rm
    ])
    return CarGeometry(centers=centers, radii=f([small_r] * 4 + [large_r] * 2),
                       bounding_center=f([bc_x, 0.0]),
                       bounding_radius=f(bc_r))


def circles_global(car: CarGeometry, x, y, heading):
    """Covering-circle centers in the global frame for states of any
    leading shape: (gx, gy), each (..., C)."""
    gx, gy, _ = local_to_global(x[..., None], y[..., None],
                                heading[..., None], car.centers[:, 0],
                                car.centers[:, 1])
    return gx, gy


def is_state_collision_free(gm: maps.GridMap, car: CarGeometry, x, y,
                            heading):
    """Exact six-circle check (isSingleStateCollisionFree,
    collision_checker.cpp:17-40). Outside the map counts as a collision."""
    gx, gy = circles_global(car, x, y, heading)
    ok = maps.is_inside(gm, gx, gy) & (maps.obstacle_distance(gm, gx, gy)
                                       >= car.radii)
    return torch.all(ok, dim=-1)


def is_state_collision_free_improved(gm: maps.GridMap, car: CarGeometry,
                                     x, y, heading):
    """The bounding-circle test, falling back to the exact test where it
    fails (isSingleStateCollisionFreeImproved, :42-59), without branches."""
    bx, by, _ = local_to_global(x, y, heading, car.bounding_center[0],
                                car.bounding_center[1])
    inside = maps.is_inside(gm, bx, by)
    coarse_free = inside & (maps.obstacle_distance(gm, bx, by)
                            >= car.bounding_radius)
    exact = is_state_collision_free(gm, car, x, y, heading)
    return (coarse_free | exact) & inside


def path_collision_free(gm: maps.GridMap, car: CarGeometry, result):
    """The fraction of the valid knots of a ``PathResult`` (a batch or one
    path) that are collision free, as a 0-d tensor."""
    free = is_state_collision_free_improved(gm, car, result.x, result.y,
                                            result.heading)
    mask = result.mask
    n = torch.clamp(mask.sum(), min=1)
    return (free & mask).sum() / n


# ---------------------------------------------------------------------------
# Box / BoxByCircles (reference: include/data_struct/data_struct.hpp:34-72).
# The reference declares these classes without defining their methods; the
# JAX package gives them working semantics, kept here: distanceTo is the
# Euclidean distance from a point to the oriented box (0 inside), and the
# circle cover follows CarGeometry's scheme for an arbitrary box.
# ---------------------------------------------------------------------------

BOX_DIR_UNKNOWN, BOX_DIR_LEFT, BOX_DIR_RIGHT = 0, 1, 2


@dataclasses.dataclass
class Box:
    """Oriented box: center pose, size and passing side
    (data_struct.hpp:34-53; Dir LEFT / RIGHT / UNKNOWN)."""

    x: torch.Tensor
    y: torch.Tensor
    heading: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    dir: torch.Tensor          # () int64, one of BOX_DIR_*


def make_box(x, y, heading, length, width, is_left=None,
             device=None) -> Box:
    """The reference's two constructors (data_struct.hpp:38-39): without
    ``is_left`` the passing side is UNKNOWN."""
    dev = resolve_device(device)
    d = BOX_DIR_UNKNOWN if is_left is None else (
        BOX_DIR_LEFT if is_left else BOX_DIR_RIGHT)
    f = lambda v: scalar(v, torch.float32, dev)  # noqa: E731
    return Box(x=f(x), y=f(y), heading=f(heading), length=f(length),
               width=f(width), dir=torch.full((), d, device=dev))


def box_distance_to(box: Box, px, py):
    """Euclidean distance from point(s) of any shape to the box, 0 inside
    (``Box::distanceTo``, data_struct.hpp:46)."""
    lx, ly, _ = global_to_local(box.x, box.y, box.heading, px, py)
    dx = torch.clamp(torch.abs(lx) - 0.5 * box.length, min=0.0)
    dy = torch.clamp(torch.abs(ly) - 0.5 * box.width, min=0.0)
    return torch.hypot(dx, dy)


def box_by_circles(box: Box, n_circles: int = 6):
    """Cover the box with ``n_circles`` equal circles along its major axis
    (``BoxByCircles``, data_struct.hpp:63-72): (centers (C, 2) global,
    radii (C,)), each radius half the diagonal of a length / C by width
    slice, so every point of the box lies in a circle."""
    step = box.length / n_circles
    offs = (torch.arange(n_circles, dtype=torch.float32,
                         device=step.device) + 0.5) * step - 0.5 * box.length
    r = 0.5 * torch.hypot(step, box.width)
    gx, gy, _ = local_to_global(box.x, box.y, box.heading, offs,
                                torch.zeros_like(offs))
    return torch.stack([gx, gy], dim=-1), r.expand(n_circles)
