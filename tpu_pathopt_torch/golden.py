"""The golden fixture: the JAX package's ``solve_batch`` result on the
8-scenario adversarial batch (``scenarios.adversarial_arrays(8)``, two per
lane, default ``PlannerConfig``), stored as ``testdata/jax_adversarial_b8.npz``,
and the tolerances the port is held to against it, on the CPU and the card.

The tolerances are end to end. Stage by stage, fed the JAX stage's own
inputs, the port agrees far more tightly (``tests/test_torch_stages.py``).
End to end the differences compound: each of the three QPs stops where its
residuals first fall inside the 2e-3 band, and float32 round-off, amplified
by the ADMM iteration, moves that point within the band. The post-smoothing
result then moves the refitted reference, and on the slalom lane that flips
0.05 m clearance-march steps of the collision bounds. Flags must be equal,
the horizon within one knot, and the ADMM iteration count within one
residual-check interval per path-QP pass.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "testdata" / "jax_adversarial_b8.npz"
BATCH = 8

PATH_FIELDS = ("x", "y", "heading", "l", "d_heading", "k", "d_k", "s")
FLAG_FIELDS = ("ok", "blocked", "ok_input", "ok_smooth", "ok_corridor",
               "ok_post", "ok_init", "ok_qp", "horizon_truncated")
COUNT_FIELDS = ("n_valid", "qp_iters")
BOUND_FIELDS = ("front_lb", "front_ub", "rear_lb", "rear_ub")

# Max abs difference over each scenario's valid knots (meters, radians, 1/m).
TOLERANCES = {"x": 0.15, "y": 0.15, "s": 0.15, "l": 0.05, "heading": 0.02,
              "d_heading": 0.02, "k": 0.02, "d_k": 0.05, "bounds": 0.3}


def arrays(res) -> dict:
    """A ``PathResult`` (either package's, any device) as the fixture's
    flat dict of numpy arrays."""
    out = {f: np.asarray(_np(getattr(res, f)))
           for f in PATH_FIELDS + FLAG_FIELDS + COUNT_FIELDS}
    for f in BOUND_FIELDS:
        out["bounds." + f] = np.asarray(_np(getattr(res.bounds, f)))
    return out


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return a


def load() -> dict:
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def compare(got: dict, want: dict, check_every: int = 25):
    """(failures, diffs): the checks that failed, as readable strings, and
    the max abs difference of every compared field."""
    failures, diffs = [], {}
    for f in FLAG_FIELDS:
        if not np.array_equal(got[f], want[f]):
            failures.append(f"{f}: {got[f].tolist()} != {want[f].tolist()}")
    dn = np.abs(got["n_valid"].astype(int) - want["n_valid"].astype(int))
    diffs["n_valid"] = int(dn.max())
    if dn.max() > 1:
        failures.append(f"n_valid differs by {dn.max()} knots")
    di = np.abs(got["qp_iters"].astype(int) - want["qp_iters"].astype(int))
    diffs["qp_iters"] = int(di.max())
    if di.max() > 2 * check_every:
        failures.append(f"qp_iters differ by {di.max()}")
    n = np.minimum(got["n_valid"], want["n_valid"])
    mask = np.arange(got["x"].shape[-1])[None] < n[:, None]
    for f in PATH_FIELDS + tuple("bounds." + b for b in BOUND_FIELDS):
        d = np.where(mask, np.abs(got[f].astype(np.float64) - want[f]), 0.0)
        diffs[f] = float(d.max())
        tol = TOLERANCES["bounds" if f.startswith("bounds.") else f]
        if not d.max() <= tol:
            failures.append(f"{f}: max abs diff {d.max():.3g} > {tol}")
    return failures, diffs
