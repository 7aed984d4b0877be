"""``directional_prescan_fallback`` and ``update_bounds_on_input_states``
of the port against the JAX package (``tests/test_bounds.py``'s cases): the
port is fed the JAX package's splines and reference states, so the bounds
logic alone is compared.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathopt import bounds as jbounds
from tpu_pathopt import maps as jmaps
from tpu_pathopt import splines as jsplines
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.refpath import build_reference_from_spline as jbuild_ref
from tpu_pathopt_torch import bounds, convert, maps, splines
from tpu_pathopt_torch.config import PlannerConfig


def t(a):
    return convert.tensor(np.array(a), "cpu")


@pytest.fixture(scope="module")
def hook():
    """tests/test_bounds.py's hook-shaped path in a 60 m corridor, with the
    arc-length hints offset by +8 m (stale hints that strand Newton), as
    (JAX (gm, xs, ys, ref), the port's on the CPU from the same arrays)."""
    res_m, size = 0.2, 300
    mask = np.zeros((size, size), bool)
    yy = (0.5 * size - 0.5 - np.arange(size)) * res_m
    mask[:, np.abs(yy) >= 25.0] = True
    tt = np.linspace(0.0, 3.6 * np.pi / 2, 80)
    x, y = 8.0 * np.sin(tt), 8.0 * (1.0 - np.cos(tt)) - 8.0
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    xs, ys = jsplines.fit_natural(f32(s), f32(x)), jsplines.fit_natural(
        f32(s), f32(y))
    ref = jbuild_ref(xs, ys, jnp.asarray(float(s[-1]) - 4.0), 64,
                     JaxConfig(n_knots=64))
    ref = ref.replace(s=ref.s + 8.0)
    as_dict = lambda o: {f.name: np.asarray(getattr(o, f.name))[None]  # noqa
                         for f in dataclasses.fields(o)}
    port = (maps.build_map(mask, resolution=res_m, device="cpu"),
            *(splines.CubicSpline(**{k: t(v) for k, v in as_dict(sp).items()})
              for sp in (xs, ys)),
            convert.ref_states(as_dict(ref), "cpu"))
    return (jmaps.build_map(jnp.asarray(mask), resolution=res_m), xs, ys,
            ref), port


BOUND_FIELDS = ("front_lb", "front_ub", "rear_lb", "rear_ub", "center_lb",
                "center_ub")


def assert_bounds_match(got, want, nv):
    for f in BOUND_FIELDS:
        np.testing.assert_allclose(getattr(got, f)[0, :nv].numpy(),
                                   np.asarray(getattr(want, f))[:nv],
                                   atol=1e-3, err_msg=f)
    assert bool(got.blocked[0]) == bool(want.blocked)
    assert int(got.n_valid[0]) == int(want.n_valid)


def test_project_directional_matches_jax(hook):
    (_, jxs, jys, jref), (_, xs, ys, ref) = hook
    cfg = JaxConfig(n_knots=64)
    h = np.asarray(jref.heading)
    cx = np.asarray(jref.x) + cfg.front_length * np.cos(h)
    cy = np.asarray(jref.y) + cfg.front_length * np.sin(h)
    rs = np.asarray(jref.s)
    args = (cx, cy, h + np.pi / 2, rs + 5.0)
    kw = dict(grid=0.5, max_grid_points=21, iters=12)
    want = jsplines.project_directional(
        jxs, jys, *(jnp.asarray(a, jnp.float32) for a in args),
        start_s=jnp.asarray(np.maximum(rs - 5.0, 0.0), jnp.float32), **kw)
    got = splines.project_directional(
        xs, ys, *(t(a[None]).float() for a in args),
        start_s=t(np.maximum(rs - 5.0, 0.0)[None]).float(), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-3)


def test_prescan_fallback_bounds_match_jax_and_rescue_newton(hook):
    """With the stale hints, bound extraction with the prescan fallback
    equals the JAX package's (the center corridor too), and differs from
    pure Newton's, which strands (tests/test_bounds.py)."""
    (jgm, jxs, jys, jref), (gm, xs, ys, ref) = hook
    nv = int(jref.n_valid)
    on, off = (dict(n_knots=64, directional_prescan_fallback=v)
               for v in (True, False))
    want = jbounds.update_bounds(jgm, jxs, jys, jref, JaxConfig(**on),
                                 with_center=True)
    got = bounds.update_bounds(gm, xs, ys, ref, PlannerConfig(**on),
                               with_center=True)
    assert_bounds_match(got, want, nv)
    stranded = bounds.update_bounds(gm, xs, ys, ref, PlannerConfig(**off))
    d_ub = (got.front_ub - stranded.front_ub)[0, :nv].abs()
    assert float(d_ub.max()) > 1.0


@pytest.mark.parametrize("d_heading", [0.0, 0.3])
def test_update_bounds_on_input_states_matches_jax(hook, d_heading):
    """The axle offsets shrunk by the input heading error
    (tests/test_bounds.py's two cases): at zero error the axle corridors
    are the center corridor."""
    (jgm, jxs, jys, jref), (gm, xs, ys, ref) = hook
    jref, ref = jref.replace(s=jref.s - 8.0), dataclasses.replace(
        ref, s=ref.s - 8.0)
    nv = int(jref.n_valid)
    dh = np.full(64, d_heading, np.float32)
    want = jbounds.update_bounds_on_input_states(
        jgm, jxs, jys, jref, jnp.asarray(dh), JaxConfig(n_knots=64))
    got = bounds.update_bounds_on_input_states(
        gm, xs, ys, ref, t(dh[None]), PlannerConfig(n_knots=64))
    assert_bounds_match(got, want, nv)
    if d_heading == 0.0:
        np.testing.assert_allclose(got.front_ub[0, :nv].numpy(),
                                   got.center_ub[0, :nv].numpy(), atol=1e-5)
