"""The planner's traffic as numpy arrays: the obstacle maps and the lane
routes of the port's ``scenarios`` module, frozen here so that a change to
the program cannot move what the benchmark sends it.

- The adversarial map: 60 m x 60 m at 0.2 m with four lanes (easy: a wide
  straight corridor; tight: pinched to 3.0 m by staggered juts; slalom:
  four posts forcing an S-weave; blocked: a dead-end wall).
- The long-route map: the same four lanes stretched along x on a map the
  size of the planner reference's demo map (701 x 710 cells at 0.2 m).
- Scenarios: a quarter of a batch per lane, each a straight route along
  its lane with a start offset of U(-1, 1) m and a start heading of
  U(-0.12, 0.12) rad, drawn from ``numpy.random.default_rng(seed)``.

Imports numpy only.
"""

from __future__ import annotations

import numpy as np

R_RAW = 16             # padded raw reference points per scenario
RESOLUTION = 0.2
SIZE = 300
LANES = ("easy", "tight", "slalom", "blocked")
LANE_Y = (16.0, 5.0, -5.0, -17.0)   # lane centre lines, in LANES' order
LONG_SHAPE = (701, 710)
LONG_X = (-60.0, 60.0)


def _mask_painter(shape):
    """(mask, block): an empty obstacle mask of ``shape`` centred on the
    origin (row 0 at max x, column 0 at max y) and a function that marks
    the cells with x_lo <= x <= x_hi and y_lo <= y <= y_hi occupied."""
    res = RESOLUTION
    mask = np.zeros(shape, bool)
    xx = (0.5 * shape[0] - 0.5 - np.arange(shape[0])) * res   # rows
    yy = (0.5 * shape[1] - 0.5 - np.arange(shape[1])) * res   # cols

    def block(x_lo, x_hi, y_lo, y_hi):
        mask[np.ix_((xx >= x_lo) & (xx <= x_hi),
                    (yy >= y_lo) & (yy <= y_hi))] = True

    mask[:, np.abs(yy) >= 24.0] = True                # outer walls
    return mask, block


def adversarial_mask() -> np.ndarray:
    """The 300 x 300 obstacle mask (True = occupied)."""
    mask, block = _mask_painter((SIZE, SIZE))

    for y_sep in (10.0, 0.0, -10.0):                  # lane separators
        block(-30.0, 30.0, y_sep - 0.4, y_sep + 0.4)
    # tight lane (y in [0.8, 9.6]): staggered juts -> 3.0 m gaps
    block(-10.0, -8.0, 0.8, 2.6)
    block(-10.0, -8.0, 5.6, 9.6)
    block(5.0, 7.0, 0.8, 4.0)
    block(5.0, 7.0, 7.0, 9.6)
    # slalom lane (y in [-9.6, -0.8]): four posts
    block(-16.0, -14.0, -9.6, -4.6)
    block(-6.0, -4.0, -5.8, -0.8)
    block(4.0, 6.0, -9.6, -4.6)
    block(14.0, 16.0, -5.8, -0.8)
    # blocked lane (y in [-23.6, -10.4]): dead-end wall across the lane
    block(10.0, 11.0, -23.6, -10.4)
    return mask


def long_route_mask() -> np.ndarray:
    """The long-route obstacle mask, LONG_SHAPE (True = occupied): the
    adversarial layout stretched along x. Lane separators from x = -66 to
    66 m; the tight lane's two staggered juts repeated every 30 m, one
    from x = -40, the other from x = -25 (a jut at x = -55 would stand
    within a car's length of the routes' start, where the JAX package's
    own paths hit it on 18 of the 64 tight lanes); 8 slalom posts every
    12.5 m from x = -43.75 to 43.75 on alternating sides; the blocked
    lane's wall at x = 40. (With 9 posts from x = -50 the JAX package's own
    slalom result moves by 100 ADMM iterations and 0.55 m of collision
    bound under a 1e-7 relative change of its inputs; on this layout it
    stays within golden.TOLERANCES, tests/test_torch_long_route.py.)"""
    mask, block = _mask_painter(LONG_SHAPE)
    for y_sep in (10.0, 0.0, -10.0):
        block(-66.0, 66.0, y_sep - 0.4, y_sep + 0.4)
    for k in (-1, 0, 1, 2):                            # tight lane
        block(-10.0 + 30 * k, -8.0 + 30 * k, 0.8, 2.6)
        block(-10.0 + 30 * k, -8.0 + 30 * k, 5.6, 9.6)
    for k in (-1, 0, 1):
        block(5.0 + 30 * k, 7.0 + 30 * k, 0.8, 4.0)
        block(5.0 + 30 * k, 7.0 + 30 * k, 7.0, 9.6)
    for j in range(8):                                 # slalom lane
        x = -43.75 + 12.5 * j
        if j % 2:
            block(x - 1.0, x + 1.0, -5.8, -0.8)
        else:
            block(x - 1.0, x + 1.0, -9.6, -4.6)
    block(40.0, 41.0, -23.6, -10.4)                    # blocked lane
    return mask


def _lane_route(y_lane, n_sc, rng, x0=-25.0, x1=25.0, offset=1.0,
                heading=0.12):
    """n_sc randomized scenarios along a straight lane at y = y_lane: start
    offset U(-offset, offset) m, start heading U(-heading, heading) rad."""
    pts, starts, targets = [], [], []
    for _ in range(n_sc):
        off = rng.uniform(-offset, offset)
        head = rng.uniform(-heading, heading)
        xs = np.linspace(x0, x1, 8)
        ys = np.full(8, y_lane)
        rx = np.concatenate([xs, np.full(R_RAW - 8, xs[-1])])
        ry = np.concatenate([ys, np.full(R_RAW - 8, ys[-1])])
        pts.append((rx, ry, 8))
        starts.append((x0, y_lane + off, head))
        targets.append((x1, y_lane, 0.0))
    return pts, starts, targets


def adversarial_arrays(batch: int = 256, seed: int = 0, x0: float = -25.0,
                       x1: float = 25.0, offset: float = 1.0,
                       heading: float = 0.12) -> dict:
    """The scenario batch as numpy arrays: raw_x/raw_y (B, R_RAW) float32,
    n_raw (B,) int32, start (B, 3) and target (B, 3) float32 [x, y,
    heading]; lanes in the order of ``LANES``, ``batch // 4`` each, routes
    from x0 to x1."""
    n = batch // 4
    rng = np.random.default_rng(seed)
    lanes = [_lane_route(y, n, rng, x0, x1, offset, heading)
             for y in LANE_Y]
    pts = sum((lane[0] for lane in lanes), [])
    return dict(
        raw_x=np.stack([p[0] for p in pts]).astype(np.float32),
        raw_y=np.stack([p[1] for p in pts]).astype(np.float32),
        n_raw=np.asarray([p[2] for p in pts], np.int32),
        start=np.asarray(sum((lane[1] for lane in lanes), []), np.float32),
        target=np.asarray(sum((lane[2] for lane in lanes), []), np.float32))


def long_route_arrays(batch: int = 256, seed: int = 0) -> dict:
    """The long-route scenario batch as numpy arrays (the layout of
    :func:`adversarial_arrays`): 120 m routes along each lane."""
    return adversarial_arrays(batch, seed, *LONG_X)


# Map name (a configuration's "map") -> its mask.
MASKS = {"adversarial": adversarial_mask, "long_route": long_route_mask}
