"""The golden fixtures: the JAX package's results on the 8-scenario
adversarial batch (``scenarios.adversarial_arrays(8)``, two per lane),
stored in ``testdata/``, and the tolerances the port is held to against
them, on the CPU and the card:

- ``jax_adversarial_b8.npz``: ``solve_batch`` at the default
  ``PlannerConfig`` (TENSION2 + DP);
- ``jax_tension_b8.npz``, ``jax_astar_b8.npz``: ``solve_batch`` under the
  configurations of :data:`CONFIGS` (TENSION + DP, TENSION2 + A*);
- ``jax_tension_dev_b8.npz``: TENSION + DP with
  ``cartesian_deviation_weight = 0.5``, which makes the TENSION optimum
  unique (the default weight 0 leaves a soft mode on straight lanes), held
  at the default tolerances;
- ``jax_rough_b8.npz``: ``solve_batch`` with
  ``rough_constraints_far_away`` (the reference's rough rows beyond
  ``precise_planning_length``), from the JAX package's XLA path: its TPU
  path's round kernel hard-codes the default collision rows and fails
  every scenario there;
- ``jax_replan_b8.npz``: :data:`REPLAN_CYCLES` cycles of the warm
  replanning stream at the default config, advancing
  :data:`REPLAN_DS` m a cycle: each cycle's result and the start pose it
  advanced to (:func:`replan_arrays`);
- ``jax_long_b8.npz``: ``solve_batch`` on 8 scenarios of the long route
  (``scenarios.build_long_route``, 120 m routes on a map the size of the
  reference's demo map) at 512 knots (``scenarios.LONG_CONFIG``), from the
  JAX package's TPU path (:func:`fixture_batch` builds its batch);
- ``jax_stretch_b8.npz``: ``solve_batch`` on lanes :data:`FIXTURE_LANES`
  of the 256-scenario long route at ``scenarios.STRETCH_CONFIG`` (384
  segment points, 300 DP layers), from the JAX package's TPU path: the
  easy lanes on which the card's geometry stage once went non-finite and
  one lane of each other lane class.

``card_geometry_384.npz`` holds no result: it is the inputs of
``pipeline.stage_geometry`` on five lanes of the long route at
``scenarios.STRETCH_CONFIG`` as the card computed them (lanes 16 and 48
with the CUDA kernels, 26, 49 and 63 with the plain rounds), on which the
card's arc-length sum once made every knot of the lane NaN
(:func:`card_geometry`).

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

import dataclasses
from pathlib import Path

import numpy as np
import torch

from tpu_pathopt_torch import corridor, maps, scenarios, splines
from tpu_pathopt_torch.torchutil import resolve_device

TESTDATA = Path(__file__).resolve().parent / "testdata"
FIXTURE = TESTDATA / "jax_adversarial_b8.npz"
FIXTURES = {"default": FIXTURE,
            "tension": TESTDATA / "jax_tension_b8.npz",
            "tension_dev": TESTDATA / "jax_tension_dev_b8.npz",
            "astar": TESTDATA / "jax_astar_b8.npz",
            "rough": TESTDATA / "jax_rough_b8.npz",
            "replan": TESTDATA / "jax_replan_b8.npz",
            "long": TESTDATA / "jax_long_b8.npz",
            "stretch": TESTDATA / "jax_stretch_b8.npz"}
# PlannerConfig keyword arguments of each fixture (both packages).
CONFIGS = {"default": {}, "tension": {"smoothing_method": "TENSION"},
           "tension_dev": {"smoothing_method": "TENSION",
                           "cartesian_deviation_weight": 0.5},
           "astar": {"corridor_method": "ASTAR"},
           "rough": {"rough_constraints_far_away": True}, "replan": {},
           "long": scenarios.LONG_CONFIG, "stretch": scenarios.STRETCH_CONFIG}
# Fixtures on the long-route batch; the others are on the adversarial one.
LONG_ROUTE = ("long", "stretch")
BATCH = 8
# Fixtures whose BATCH scenarios are these lanes of the route's 256-scenario
# batch (the others take the route's own BATCH-scenario batch).
FIXTURE_LANES = {"stretch": (16, 26, 48, 49, 63, 80, 144, 208)}
REPLAN_CYCLES = 3
REPLAN_DS = 1.0
POSE_FIELDS = ("start_x", "start_y", "start_heading", "start_k")

PATH_FIELDS = ("x", "y", "heading", "l", "d_heading", "k", "d_k", "s")
FLAG_FIELDS = ("ok", "blocked", "ok_input", "ok_smooth", "ok_corridor",
               "ok_post", "ok_init", "ok_qp", "horizon_truncated")
COUNT_FIELDS = ("n_valid", "qp_iters")
BOUND_FIELDS = ("front_lb", "front_ub", "rear_lb", "rear_ub")

# Max abs difference over each scenario's valid knots (meters, radians, 1/m).
TOLERANCES = {"x": 0.15, "y": 0.15, "s": 0.15, "l": 0.05, "heading": 0.02,
              "d_heading": 0.02, "k": 0.02, "d_k": 0.05, "bounds": 0.3}

# The scenarios of each fixture whose paths are compared (flags and counts
# are compared on all). Under A* the tight and slalom lanes (scenarios 2-5)
# are chaotic in the JAX package itself: a relative 1e-7 change of its raw
# points moves its result there by up to 0.52 m in x, 0.26 m in l and 3.1 m
# in the collision bounds (tests/test_torch_fixtures.py shows it), as the A*
# node costs tie closely and a corridor march step flips. There only the
# flags and counts are held.
PATH_LANES = {"astar": np.array([True, True] + [False] * 4 + [True, True])}

# Fixtures held to other tolerances. The TENSION smoothing QP stops after
# one round anywhere in its termination band, eps_abs + eps_rel |A v| of
# about 0.05 m (|A v| is the 25 m of the coordinates; TENSION2's rows are
# increments of about 1 m, so its band is 0.004 m), and the path's l is
# its offset from the smoothed reference: l's tolerance is the default's
# plus that band. The JAX package's own XLA and TPU paths differ by 0.13 m
# in l on this batch.
FIXTURE_TOLERANCES = {"tension": {**TOLERANCES, "l": 0.1}}


def arrays(res) -> dict:
    """A ``PathResult`` (either package's, any device) as the fixture's
    flat dict of numpy arrays."""
    out = {f: np.asarray(_np(getattr(res, f)))
           for f in PATH_FIELDS + FLAG_FIELDS + COUNT_FIELDS}
    for f in BOUND_FIELDS:
        out["bounds." + f] = np.asarray(_np(getattr(res.bounds, f)))
    return out


def fixture_arrays(name: str) -> dict:
    """The numpy scenario arrays of fixture ``name``'s BATCH scenarios (the
    layout of ``scenarios.adversarial_arrays``): the long route's for
    :data:`LONG_ROUTE`, else the adversarial batch's, cut to
    :data:`FIXTURE_LANES` where the fixture names lanes."""
    make = (scenarios.long_route_arrays if name in LONG_ROUTE
            else scenarios.adversarial_arrays)
    lanes = FIXTURE_LANES.get(name)
    if lanes is None:
        return make(BATCH)
    return {k: v[list(lanes)] for k, v in make(256).items()}


CARD_GEOMETRY = TESTDATA / "card_geometry_384.npz"


def card_geometry(device=None) -> dict:
    """The stage_geometry inputs in :data:`CARD_GEOMETRY` on ``device``:
    ``gm`` and ``scs`` (the long route's map and those lanes of its
    256-scenario batch), ``xs2``, ``ys2``, ``cor``, ``l_post``, and
    ``lane`` and ``run`` (numpy: each row's lane and the rounds that made
    it, "kernels" or "plain")."""
    z = load(CARD_GEOMETRY)
    dev = resolve_device(device)
    t = lambda k: torch.as_tensor(z[k], device=dev)  # noqa: E731
    spline = lambda p: splines.CubicSpline(**{  # noqa: E731
        f.name: t(f"{p}.{f.name}") for f in dataclasses.fields(
            splines.CubicSpline)})
    gm = maps.build_map(scenarios.long_route_mask(),
                        resolution=scenarios.RESOLUTION,
                        pad_shape=scenarios.PAD_SHAPE, device=dev)
    arrays = {k: v[z["lane"]] for k, v in
              scenarios.long_route_arrays(256).items()}
    return dict(gm=gm, scs=scenarios.scenario_batch(arrays, dev),
                xs2=spline("xs2"), ys2=spline("ys2"),
                cor=corridor.Corridor(**{f.name: t(f"cor.{f.name}")
                                         for f in dataclasses.fields(
                                             corridor.Corridor)}),
                l_post=t("l_post"), lane=z["lane"], run=z["run"])


def fixture_batch(name: str, device=None):
    """(GridMap, Scenario batch) of fixture ``name``'s BATCH scenarios on
    ``device`` (:func:`fixture_arrays`) with their map."""
    mask = (scenarios.long_route_mask() if name in LONG_ROUTE
            else scenarios.adversarial_mask())
    gm = maps.build_map(mask, resolution=scenarios.RESOLUTION,
                        pad_shape=scenarios.PAD_SHAPE, device=device)
    return gm, scenarios.scenario_batch(fixture_arrays(name), device)


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return a


def compare_fixture(name: str, got: dict, want: dict):
    """:func:`compare` (or :func:`compare_replan`) at the fixture's own
    lanes and tolerances."""
    if name == "replan":
        return compare_replan(got, want)
    return compare(got, want, lanes=PATH_LANES.get(name),
                   tolerances=FIXTURE_TOLERANCES.get(name))


def load(path=FIXTURE) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def replan_arrays(step, scs, warm, n_steps: int = REPLAN_CYCLES) -> dict:
    """Run ``n_steps`` replanning cycles ``step(scs, warm) -> (PathResult,
    warm, advanced scenarios)`` (either package's ``replan_step``) and
    return the replan fixture's flat dict: cycle c's :func:`arrays` under
    ``"c{c}.<field>"`` and its advanced start pose under
    ``"c{c}.start_x"`` etc."""
    out = {}
    for c in range(n_steps):
        res, warm, scs = step(scs, warm)
        out.update({f"c{c}.{k}": v for k, v in arrays(res).items()})
        out.update({f"c{c}.{f}": np.asarray(_np(getattr(scs, f)))
                    for f in POSE_FIELDS})
    return out


def compare_replan(got: dict, want: dict, check_every: int = 25):
    """:func:`compare` for every cycle of two replan fixture dicts, and each
    cycle's advanced start pose within the path tolerances (x, y, heading,
    k). Failures and diffs are prefixed with their cycle."""
    failures, diffs = [], {}
    pose_tol = dict(start_x="x", start_y="y", start_heading="heading",
                    start_k="k")
    for c in range(REPLAN_CYCLES):
        pre = f"c{c}."
        cut = lambda d: {k[len(pre):]: v for k, v in d.items()  # noqa: E731
                         if k.startswith(pre)}
        g, w = cut(got), cut(want)
        f, d = compare(g, w, check_every)
        failures += [pre + x for x in f]
        diffs.update({pre + k: v for k, v in d.items()})
        for name, tol in pose_tol.items():
            dp = float(np.abs(g[name].astype(np.float64) - w[name]).max())
            diffs[pre + name] = dp
            if not dp <= TOLERANCES[tol]:
                failures.append(f"{pre}{name}: max abs diff {dp:.3g} > "
                                f"{TOLERANCES[tol]}")
    return failures, diffs


def compare(got: dict, want: dict, check_every: int = 25, lanes=None,
            tolerances=None):
    """(failures, diffs): the checks that failed, as readable strings, and
    the max abs difference of every compared field. ``lanes`` (a boolean
    mask over the batch, default all) picks the scenarios whose paths and
    bounds are compared; flags and counts are compared on every scenario.
    ``tolerances`` defaults to :data:`TOLERANCES`."""
    tolerances = tolerances or TOLERANCES
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
    if lanes is not None:
        mask &= np.asarray(lanes, bool)[:, None]
    for f in PATH_FIELDS + tuple("bounds." + b for b in BOUND_FIELDS):
        d = np.where(mask, np.abs(got[f].astype(np.float64) - want[f]), 0.0)
        diffs[f] = float(d.max())
        tol = tolerances["bounds" if f.startswith("bounds.") else f]
        if not d.max() <= tol:
            failures.append(f"{f}: max abs diff {d.max():.3g} > {tol}")
    return failures, diffs
