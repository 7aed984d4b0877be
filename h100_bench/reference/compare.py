"""Judge the program's answers against the plain reference's.

An answer is one planned query: its path (x, y, heading, l, d_heading, k,
d_k over ``n_valid`` knots), its flags (``ok``, ``blocked``) and its
collision bounds (front and rear, lower and upper). :func:`numbers` compares
one answer with the reference's for the same query; :func:`judge` takes the
worst of each number over a run's sample and holds it to its limit.
"""

from __future__ import annotations

import numpy as np

BOUND_ROWS = ("front_lb", "front_ub", "rear_lb", "rear_ub")
# The path cost is compared relative to the reference's, or to this floor
# where the reference's is smaller: a nearly straight path costs far below
# 1, and at the planner's eps 2e-3 two sound solves of it differ by a few
# hundredths in absolute terms.
COST_FLOOR = 1.0
# The worst of each number over a run's sample is held to its limit.
WORST = {"flags": sum, "knots_off": max, "refline_m": max,
         "bound_mean_m": max, "cost_gap": max, "start_m": max,
         "kink_m": max}


def bf16(a):
    """``a`` rounded to bfloat16 (8 bits of mantissa, to nearest even), as
    float64."""
    a = np.asarray(a, np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def answer(path: dict, bounds: dict, s) -> dict:
    """An answer in the form :func:`numbers` reads, from the reference's
    ``solve()`` output (``out["path"]``, ``out["bounds"]``, ``out["ref"]
    ["s"]``); ``s`` is the arc length along the path's knots."""
    n = int(path["n_valid"])
    a = {k: np.asarray(path[k], np.float64)[:n] for k in
         ("x", "y", "heading", "l", "d_heading", "k", "d_k")}
    a.update({k: np.asarray(bounds[k], np.float64)[:n] for k in BOUND_ROWS})
    a["s"] = np.concatenate([[0.0], np.cumsum(np.hypot(
        np.diff(a["x"]), np.diff(a["y"])))])
    a.update(n_valid=n, ok=bool(path["ok"]), blocked=bool(path["blocked"]))
    return a


def reference_line(a):
    """The line the path's l is measured from: each knot moved back by l
    along the normal of the reference heading (heading - d_heading)."""
    h = a["heading"] - a["d_heading"]
    return a["x"] + a["l"] * np.sin(h), a["y"] - a["l"] * np.cos(h)


def bound_points(a):
    """Where each collision bound lies on the map: the reference line's
    knot moved by the bound along the normal of the reference heading.
    Bounds are offsets from a line that may itself differ by ``refline_m``
    between two sound answers; their points do not."""
    x, y = reference_line(a)
    h = a["heading"] - a["d_heading"]
    return [(x - a[k] * np.sin(h), y + a[k] * np.cos(h)) for k in BOUND_ROWS]


def leave_bounds(a: dict, bounds: dict, cfg, m: int):
    """At each of the first ``m`` knots, how far path ``a``'s front and rear
    circles (offset l plus the axle's length times the heading error, as
    the path QP's collision rows have them) lie outside ``bounds``' lateral
    bounds; 0 where inside."""
    out = np.zeros(m)
    for side, length in (("front", cfg.front_length),
                         ("rear", cfg.rear_length)):
        pos = a["l"][:m] + length * a["d_heading"][:m]
        out = np.maximum(out, np.maximum(bounds[side + "_lb"][:m] - pos,
                                         pos - bounds[side + "_ub"][:m]))
    return out


def numbers(got: dict, want: dict, cfg) -> dict:
    m = min(got["n_valid"], want["n_valid"])
    flags = (got["ok"] != want["ok"]) + (got["blocked"] != want["blocked"])
    gx, gy = reference_line(got)
    wx, wy = reference_line(want)
    bound = np.stack([np.hypot(*(np.asarray(p)[:, :m] - np.asarray(q)[:, :m]))
                      for p, q in zip(bound_points(got), bound_points(want))])
    # How much farther the path leaves the reference's bounds than the
    # reference's own path does at the same knot: the collision rows are
    # soft (penalized slacks), so a sound path may leave them too.
    clear = np.maximum(leave_bounds(got, want, cfg, m)
                       - leave_bounds(want, want, cfg, m), 0.0)

    def cost(a):
        return float(cfg.weight_kappa * np.sum(a["k"][:m] ** 2)
                     + cfg.weight_dkappa * np.sum(a["d_k"][:m] ** 2))
    c_got, c_want = cost(got), cost(want)
    return dict(flags=int(flags),
                knots_off=abs(got["n_valid"] - want["n_valid"]),
                refline_m=float(np.hypot(gx[:m] - wx[:m],
                                         gy[:m] - wy[:m]).max(initial=0.0)),
                bound_mean_m=float(bound.mean()) if m else 0.0,
                cost_gap=abs(c_got - c_want) / max(c_want, COST_FLOOR),
                bound_max_m=float(bound.max(initial=0.0)),
                clear_m=float(clear.max(initial=0.0)),
                kink_m=max(kink(got) - kink(want), 0.0))


def kink(a: dict) -> float:
    """How far the path's points leave its own headings: the widest
    sideways offset of one knot from the next, across the heading halfway
    between them. A smooth curve sampled at 0.3 m reads up to a few
    hundredths of a metre, as much as the reference's own path does; a
    knot moved off its path reads its move. :func:`numbers` holds the
    program's answer to what it reads beyond the reference's."""
    x, y, h = a["x"], a["y"], a["heading"]
    if len(x) < 2:
        return 0.0
    hm = np.arctan2(np.sin(h[:-1]) + np.sin(h[1:]),
                    np.cos(h[:-1]) + np.cos(h[1:]))
    return float(np.abs(np.diff(x) * np.sin(hm)
                        - np.diff(y) * np.cos(hm)).max())


def start_gap(a: dict, start) -> float:
    """How far answer ``a``'s first knot lies from the query's start
    position: the path QP pins its first knot there, so this holds where
    the path lies as well as its shape. 0 for an answer with no knot."""
    if not a["n_valid"]:
        return 0.0
    return float(np.hypot(a["x"][0] - start[0], a["y"][0] - start[1]))


def judge(rows: list, limits: dict, whole: dict | None = None):
    """(correct, checks): the worst of each number over ``rows`` (one dict
    of numbers per answer), and each number of the whole run in ``whole``
    (such as the queries that came back not ok), beside its limit; correct
    when every number with a limit is within it."""
    checks = {}
    for name, worst in WORST.items():
        vals = [r[name] for r in rows if name in r]
        if vals and name in limits:
            checks[name] = {"value": worst(vals), "limit": limits[name]}
    for name, value in (whole or {}).items():
        if name in limits:
            checks[name] = {"value": value, "limit": limits[name]}
    ok = bool(rows) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
