"""The fixtures of the port's second configuration and of its replanning
loop, and the JAX package's own sensitivity that sets what they can hold.

Each fixture in ``tpu_pathopt_torch/testdata/`` is a JAX package result on
``bench.build_adversarial(8)`` on its TPU path (:func:`jax_tpu_path`: its
four Pallas kernels in interpret mode), the function the port computes:

- ``jax_tension_b8.npz``: ``solve_batch`` under TENSION + DP;
- ``jax_tension_dev_b8.npz``: the same with ``cartesian_deviation_weight
  = 0.5``, which makes the TENSION optimum unique (regenerated by
  ``tests/test_torch_tension_dev.py``);
- ``jax_astar_b8.npz``: ``solve_batch`` under TENSION2 + A*;
- ``jax_replan_b8.npz``: 3 cycles of the warm replanning stream at the
  default config, 1 m a cycle (``golden.replan_arrays``);
- ``jax_long_b8.npz``: ``solve_batch`` on 8 scenarios of the long route
  (``scenarios.long_route_arrays(8)`` on ``scenarios.long_route_mask()``)
  at 512 knots (regenerated by ``tests/test_torch_long_route.py``);
- ``jax_stretch_b8.npz``: the same on 8 lanes of the 256-scenario long
  route (``golden.FIXTURE_LANES``) at ``scenarios.STRETCH_CONFIG``, 384
  segment points (regenerated by ``tests/test_torch_long_stretch.py``).

``jax_rough_b8.npz`` (``solve_batch`` with ``rough_constraints_far_away``)
is the exception: :func:`jax_rough_arrays` takes the JAX package's XLA
path, the CPU default. Its TPU path fails all 8 scenarios under that
setting, at max_iter in both passes with NaN paths, because its Pallas
round kernel hard-codes the default collision rows of scenario 0's first
knot at every knot (``tpu_pathopt/solver/fused_rounds.py:202-246``), so it
iterates another operator than the one the XLA path factors and solves
(``tests/test_torch_knobs.py`` shows the round). The port takes each knot's
rows, as the XLA path does.

:func:`write_fixtures` writes all of them::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \\
import test_torch_fixtures as t; t.write_fixtures()"

On the CPU the JAX package otherwise takes its XLA path, whose TENSION
smoothing lands 0.16 m from the TPU path's on this batch (both inside the
QP's termination band), enough to move the end result beyond the golden
tolerances. The tests here regenerate each fixture and compare it with the
stored file: flags and counts exactly, values to float32 round-off across
machines.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest

import bench
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt import replan as jreplan
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import golden

VARIANTS = ("tension", "tension_dev", "astar")


@contextlib.contextmanager
def jax_tpu_path():
    """Run the JAX package as it runs on a TPU: its four Pallas kernels
    (K1-K4) in interpret mode and ``jax.default_backend()`` reporting
    "tpu", so every stage takes its fused path. Traces made before or
    inside are dropped on entry and on exit."""
    from tpu_pathopt import corridor as jcorridor
    from tpu_pathopt.solver import fused_rounds as jfused
    saved = [(jfused, name, getattr(jfused, name)) for name in (
        "fused_factor", "fused_structured_round", "fused_admm_round")]
    saved.append((jcorridor, "_dp_forward_pallas",
                  jcorridor._dp_forward_pallas))
    for mod, name, fn in saved:
        setattr(mod, name, functools.partial(fn, interpret=True))
    saved.append((jax, "default_backend", jax.default_backend))
    jax.default_backend = lambda: "tpu"
    jax.clear_caches()
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        jax.clear_caches()


def jax_variant_arrays(name: str, scales=(1.0,)) -> list:
    """The JAX package's solve_batch on the golden batch under a variant
    configuration, on its TPU path, as flat arrays: one dict for each
    scale of the raw points (one compilation for all)."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    cfg = JaxConfig(**golden.CONFIGS[name])
    out = []
    with jax_tpu_path():
        for scale in scales:
            moved = scs.replace(raw_x=scs.raw_x * scale,
                                raw_y=scs.raw_y * scale)
            res = jpipe.solve_batch_jit(gm, moved, cfg)
            out.append(golden.arrays(jax.tree_util.tree_map(np.asarray,
                                                            res)))
    return out


def jax_replan_arrays() -> dict:
    """The JAX package's warm replanning stream on the golden batch, on its
    TPU path, as the replan fixture's flat dict."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    cfg = JaxConfig(**golden.CONFIGS["replan"])
    with jax_tpu_path():
        return golden.replan_arrays(
            lambda s, w: jreplan.replan_step(gm, s, w, cfg, None,
                                             golden.REPLAN_DS),
            scs, jpipe.QPWarmStart.cold(golden.BATCH, cfg))


def jax_rough_arrays() -> dict:
    """The JAX package's solve_batch on the golden batch under the rough
    far-away rows, on its XLA path (see the module docstring), as the
    rough fixture's flat dict."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    res = jpipe.solve_batch_jit(gm, scs, JaxConfig(**golden.CONFIGS["rough"]))
    return golden.arrays(jax.tree_util.tree_map(np.asarray, res))


def jax_scenarios(arrays: dict):
    """The JAX package's Scenario batch from ``scenarios``-style numpy
    arrays (``adversarial_arrays``, ``long_route_arrays``)."""
    import jax.numpy as jnp
    s, g = arrays["start"], arrays["target"]
    j = jnp.asarray
    return jpipe.Scenario(
        raw_x=j(arrays["raw_x"]), raw_y=j(arrays["raw_y"]),
        n_raw=j(arrays["n_raw"]), start_x=j(s[:, 0]), start_y=j(s[:, 1]),
        start_heading=j(s[:, 2]), start_k=jnp.zeros(len(s), jnp.float32),
        target_x=j(g[:, 0]), target_y=j(g[:, 1]), target_heading=j(g[:, 2]))


def jax_long_arrays(scales=(1.0,), name: str = "long") -> list:
    """The JAX package's solve_batch on a long-route fixture's 8 scenarios
    (``golden.fixture_arrays``) at its config (the long fixture's: 512
    knots), on its TPU path, as flat arrays: one dict for each scale of
    the raw points."""
    import jax.numpy as jnp
    from tpu_pathopt import maps as jmaps
    from tpu_pathopt_torch import scenarios
    gm = jmaps.build_map(jnp.asarray(scenarios.long_route_mask()),
                         resolution=scenarios.RESOLUTION,
                         pad_shape=scenarios.PAD_SHAPE)
    arrays = golden.fixture_arrays(name)
    cfg = JaxConfig(**golden.CONFIGS[name])
    out = []
    with jax_tpu_path():
        for scale in scales:
            moved = dict(arrays, raw_x=arrays["raw_x"] * np.float32(scale),
                         raw_y=arrays["raw_y"] * np.float32(scale))
            res = jpipe.solve_batch_jit(gm, jax_scenarios(moved), cfg)
            out.append(golden.arrays(jax.tree_util.tree_map(np.asarray,
                                                            res)))
    return out


def write_fixtures():
    """(Re)write the TENSION (both weights), A*, replan, rough, long and
    stretch fixtures from the JAX package."""
    for name in VARIANTS:
        np.savez_compressed(golden.FIXTURES[name],
                            **jax_variant_arrays(name)[0])
    np.savez_compressed(golden.FIXTURES["replan"], **jax_replan_arrays())
    np.savez_compressed(golden.FIXTURES["rough"], **jax_rough_arrays())
    for name in golden.LONG_ROUTE:
        np.savez_compressed(golden.FIXTURES[name],
                            **jax_long_arrays(name=name)[0])


def assert_regenerates(got: dict, want: dict):
    assert set(got) == set(want)
    for f, w in want.items():
        base = f.rsplit(".", 1)[-1]
        if base in golden.FLAG_FIELDS + golden.COUNT_FIELDS:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], w, atol=1e-3, err_msg=f)


def test_tension_fixture_regenerates_and_its_l_needs_the_smoothing_band():
    """The TENSION fixture regenerates; and why golden.FIXTURE_TOLERANCES
    widens its l by the smoothing QP's termination band: the JAX package's
    own XLA path (the CPU's) lands beyond the default l tolerance from its
    TPU path, with the same flags."""
    want = golden.load(golden.FIXTURES["tension"])
    assert_regenerates(jax_variant_arrays("tension")[0], want)
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    res = jpipe.solve_batch_jit(gm, scs,
                                JaxConfig(**golden.CONFIGS["tension"]))
    xla = golden.arrays(jax.tree_util.tree_map(np.asarray, res))
    for f in golden.FLAG_FIELDS:
        np.testing.assert_array_equal(xla[f], want[f], err_msg=f)
    m = np.arange(want["x"].shape[-1])[None] < want["n_valid"][:, None]
    dl = np.abs(np.where(m, xla["l"] - want["l"], 0)).max()
    assert dl > golden.TOLERANCES["l"]


def test_astar_fixture_regenerates_and_its_middle_lanes_are_chaotic():
    """The A* fixture regenerates; and why golden.PATH_LANES leaves its
    tight and slalom lanes out of the path comparison: a relative -1e-7
    change of the raw points (one float32 ulp) moves the JAX package's own
    A* result there beyond golden.TOLERANCES, while its easy and blocked
    lanes stay within round-off and a 0.05 m clearance-march step, and no
    flag moves."""
    want = golden.load(golden.FIXTURES["astar"])
    got, moved = jax_variant_arrays("astar", scales=(1.0, 1 - 1e-7))
    assert_regenerates(got, want)
    lanes = golden.PATH_LANES["astar"]
    failures, _ = golden.compare(moved, want, lanes=lanes)
    assert not failures, failures
    m = np.arange(want["x"].shape[-1])[None] < want["n_valid"][:, None]
    d = {f: np.abs(np.where(m, moved[f] - want[f], 0)).max(axis=1)
         for f in ("x", "l", "bounds.front_lb")}
    assert d["x"][4:6].max() > golden.TOLERANCES["x"]            # slalom
    assert d["l"][2:4].max() > golden.TOLERANCES["l"]            # tight
    assert d["bounds.front_lb"][2:4].max() > golden.TOLERANCES["bounds"]
    assert d["x"][lanes].max() < 1e-2 and d["l"][lanes].max() < 1e-2
    assert d["bounds.front_lb"][lanes].max() < 0.05 + 1e-3


def test_replan_fixture_regenerates():
    want = golden.load(golden.FIXTURES["replan"])
    assert sorted({k.split(".")[0] for k in want}) == [
        f"c{c}" for c in range(golden.REPLAN_CYCLES)]
    assert_regenerates(jax_replan_arrays(), want)


def test_rough_fixture_regenerates_on_the_xla_path():
    want = golden.load(golden.FIXTURES["rough"])
    assert_regenerates(jax_rough_arrays(), want)


@pytest.mark.parametrize("name", VARIANTS + ("replan", "rough", "long",
                                             "stretch"))
def test_fixtures_are_all_ok(name):
    """Every stored scenario (every cycle's, for the stream) succeeded in
    the JAX package."""
    d = golden.load(golden.FIXTURES[name])
    oks = [v for k, v in d.items() if k.rsplit(".", 1)[-1] == "ok"]
    assert oks and all(bool(v.all()) for v in oks)
