"""The long route at 384 segment points (``scenarios.STRETCH_CONFIG``)
against the JAX package, and the fault the card showed there.

- The geometry stage on inputs the card computed at the stretch config
  (``golden.card_geometry``: lanes 16 and 48 with the CUDA kernels, 26, 49
  and 63 with the plain rounds), on which the card's stage once made the
  whole lane NaN. Each of these lanes ends on a DP layer one float32 ulp
  past the one before it: the 1e-6 in the layer count of
  ``corridor._build_lattice_geom`` is below float32's resolution at 82
  layers, in both packages. So the refit's arc length has a one-ulp
  interval, which a float32 sum in another order can round to zero, and
  ``splines.fit_natural`` divides by it. The GPU's cumsum did; so does the
  JAX package's own associative scan on lanes 26, 49 and 63, where its
  stage returns n_valid 0. The port sums the arc length in float64 and
  rounds once (``splines.refit``): finite on every lane, and
  within ``chip_smoke.GEOMETRY_TOL`` of the JAX stage where that is finite.
  ``chip_smoke.check_card_geometry`` runs the same stage on the card.
- ``solve_batch`` at the stretch config on ``golden.FIXTURE_LANES`` against
  ``jax_stretch_b8.npz`` at ``golden.TOLERANCES``.
- The stretch fixture regenerates from the JAX package's TPU path, and a
  1e-7 relative change of its raw points moves that result by no more
  than ``golden.TOLERANCES`` (marked slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GEOMETRY_TOL, geometry_arrays
from tpu_pathopt import corridor as jcorridor
from tpu_pathopt import maps as jmaps
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt import splines as jsplines
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import golden, pipeline, scenarios, splines
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import normal_offset

from test_torch_fixtures import assert_regenerates, jax_long_arrays, \
    jax_scenarios

STRETCH = PlannerConfig(**scenarios.STRETCH_CONFIG)


def jax_map():
    """The long route's map, built by the JAX package."""
    return jmaps.build_map(jnp.asarray(scenarios.long_route_mask()),
                           resolution=scenarios.RESOLUTION,
                           pad_shape=scenarios.PAD_SHAPE)


def jax_inputs(d: dict):
    """golden.card_geometry's port inputs as the JAX stage's (the splines
    and the corridor, int32 counts)."""
    def arr(v):
        v = v.numpy()
        return jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)

    def fields(obj, cls):
        return cls(**{k: arr(getattr(obj, k)) for k in
                      cls.__dataclass_fields__})

    return (fields(d["xs2"], jsplines.CubicSpline),
            fields(d["ys2"], jsplines.CubicSpline),
            fields(d["cor"], jcorridor.Corridor), arr(d["l_post"]))


@pytest.fixture(scope="module")
def card_stage():
    """(inputs, the port's stage, the JAX stage) on golden.card_geometry's
    five lanes, each stage's output as geometry_arrays' dict."""
    d = golden.card_geometry("cpu")
    port = geometry_arrays(pipeline.stage_geometry(
        d["gm"], d["scs"], d["xs2"], d["ys2"], d["cor"], d["l_post"],
        STRETCH))
    arrays = {k: v[d["lane"]] for k, v in
              scenarios.long_route_arrays(256).items()}
    want = jax.jit(jpipe.stage_geometry, static_argnames=("config",))(
        jax_map(), jax_scenarios(arrays), *jax_inputs(d),
        JaxConfig(**scenarios.STRETCH_CONFIG))
    ref, cb, *_, n_valid = jax.tree_util.tree_map(np.asarray, want)
    out = {f: getattr(ref, f) for f in ("x", "y", "heading", "k")}
    out.update({f: getattr(cb, f) for f in golden.BOUND_FIELDS})
    out["n_valid"] = n_valid
    out["s"] = ref.s
    return d, port, out


def refit_knots(d: dict):
    """The geometry stage's polyline (x3, y3), as stage_geometry makes it."""
    xs2, ys2, cor = d["xs2"], d["ys2"], d["cor"]
    return normal_offset(splines.evaluate(xs2, cor.layers_s),
                         splines.evaluate(ys2, cor.layers_s),
                         splines.heading(xs2, ys2, cor.layers_s),
                         d["l_post"])


def test_card_inputs_end_on_a_layer_one_ulp_past_the_last(card_stage):
    """The cause: on every captured lane the corridor's last layer stands
    one float32 ulp past the layer before it, so the refit's arc length
    has a one-ulp interval there; the port's arc length is the float64
    sum of the segments rounded once, which keeps that interval, while
    the JAX package's float32 scan rounds it to zero on lanes 26, 49 and
    63."""
    d, _, _ = card_stage
    n = d["cor"].n_layers.numpy()
    ls = d["cor"].layers_s.numpy()
    rows = np.arange(len(n))
    assert (n == 84).all()
    last, before = ls[rows, n - 1], ls[rows, n - 2]
    np.testing.assert_array_equal(last, np.nextafter(before, np.inf))
    x3, y3 = refit_knots(d)
    xs3, _, _ = splines.refit(x3, y3, d["cor"].n_layers)
    seg = torch.hypot(torch.diff(x3, dim=-1), torch.diff(y3, dim=-1))
    keep = torch.arange(seg.shape[-1]) <= d["cor"].n_layers[:, None] - 2
    seg = torch.where(keep, torch.clamp(seg, min=1e-6), 1.0).numpy()
    want = np.cumsum(seg.astype(np.float64), -1).astype(np.float32)
    np.testing.assert_array_equal(xs3.s[:, 1:].numpy(), want)
    h_port = want[rows, n - 2] - want[rows, n - 3]
    assert (h_port > 0).all()
    h_jax = np.diff(np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(seg))),
                    axis=-1)[rows, n - 3]
    np.testing.assert_array_equal(h_jax == 0, d["run"] == "plain")


@pytest.mark.parametrize("row", range(5))
def test_port_geometry_on_card_inputs_is_finite_and_matches_jax(card_stage,
                                                                 row):
    """The port's geometry stage is finite on every captured lane with its
    route's 401 knots; where the JAX stage is finite (the kernels' lanes
    16 and 48) the two agree within chip_smoke.GEOMETRY_TOL with n_valid
    equal; on the plain rounds' lanes 26, 49 and 63 the JAX stage's own
    float32 arc length makes the lane NaN (n_valid 0), a fault of the
    reference the port does not copy."""
    d, port, jx = card_stage
    n = int(port["n_valid"][row])
    assert n == 401
    for f in ("x", "y", "heading", "k") + golden.BOUND_FIELDS:
        assert np.isfinite(port[f][row, :n]).all(), f
    if d["run"][row] == "plain":
        assert jx["n_valid"][row] == 0
        assert not np.isfinite(jx["s"][row]).any()
        return
    assert jx["n_valid"][row] == n
    for f, v in port.items():
        if f == "n_valid":
            continue
        tol = GEOMETRY_TOL.get(f, GEOMETRY_TOL["bounds"])
        assert np.abs(v[row, :n].astype(np.float64) - jx[f][row, :n]).max() \
            <= tol, f


def test_port_matches_stretch_fixture_on_cpu():
    """solve_batch at 384 segment points on the stretch fixture's lanes
    against the JAX package's TPU path: every flag equal, the paths at
    golden.TOLERANCES, every scenario ok and none off the blocked lane
    truncated."""
    gm, scs = golden.fixture_batch("stretch", "cpu")
    assert STRETCH.n_segment_points == 384 and STRETCH.dp_layers == 300
    want = golden.load(golden.FIXTURES["stretch"])
    got = golden.arrays(pipeline.solve_batch(gm, scs, STRETCH, device="cpu"))
    failures, diffs = golden.compare_fixture("stretch", got, want)
    assert not failures, (failures, diffs)
    assert "stretch" not in golden.FIXTURE_TOLERANCES
    assert "stretch" not in golden.PATH_LANES
    assert got["ok"].all() and not got["horizon_truncated"].any()
    assert (got["n_valid"][:7] >= 400).all()


@pytest.mark.slow
def test_stretch_fixture_regenerates_and_the_jax_result_is_stable():
    """The stretch fixture regenerates; and the JAX package's own result on
    it moves by no more than golden.TOLERANCES under a relative -1e-7 and
    +1e-7 change of the raw points."""
    want = golden.load(golden.FIXTURES["stretch"])
    got, lo, hi = jax_long_arrays(scales=(1.0, 1 - 1e-7, 1 + 1e-7),
                                  name="stretch")
    assert_regenerates(got, want)
    for moved in (lo, hi):
        failures, diffs = golden.compare(moved, want)
        assert not failures, (failures, diffs)
