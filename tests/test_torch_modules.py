"""The port's geometry-layer modules against the JAX package's, on the same
seeded inputs: geometry, splines, B-spline, segmentation, the grid map and
its EDT (also against scipy), the DP lattice and corridor finish, the
reference resampling and the collision bounds.

Every JAX function here is per scenario; it runs under ``jax.vmap`` over the
same batch the port takes as a leading axis. Tolerances are float32 round-off
of two summation orders (the port's Thomas sweep against the JAX package's
associative scans, gathers against one-hot selects) unless a test says
otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from tpu_pathopt import bounds as jbounds
from tpu_pathopt import bspline as jbspline
from tpu_pathopt import corridor as jcorridor
from tpu_pathopt import geometry as jgeometry
from tpu_pathopt import maps as jmaps
from tpu_pathopt import refpath as jrefpath
from tpu_pathopt import splines as jsplines
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.smoothing.segment import segment_raw_reference as jsegment
from tpu_pathopt_torch import (bounds, bspline, convert, corridor, geometry,
                               maps, refpath, scenarios, splines)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.smoothing.segment import segment_raw_reference

CFG, JCFG = PlannerConfig(), JaxConfig()


def t(a):
    return convert.tensor(np.array(a), "cpu")


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@pytest.fixture(scope="module")
def curves():
    """Three padded polylines (B, 40) along wavy curves, 28/34/40 valid
    points at irregular spacing, with their cumulative arc length."""
    rng = np.random.default_rng(0)
    B, M = 3, 40
    nv = np.array([28, 34, 40])
    x = np.zeros((B, M), np.float32)
    y = np.zeros((B, M), np.float32)
    for b in range(B):
        u = np.cumsum(rng.uniform(0.6, 1.4, M))
        x[b] = u
        y[b] = (2.0 + b) * np.sin(u / (6.0 + 2 * b)) + 0.3 * b
        x[b, nv[b]:] = x[b, nv[b] - 1]
        y[b, nv[b]:] = y[b, nv[b] - 1]
    seg = np.hypot(np.diff(x), np.diff(y))
    seg = np.where(np.arange(M - 1) < (nv - 1)[:, None], seg, 1.0)
    s = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, -1)], -1)
    return x, y, s.astype(np.float32), nv.astype(np.int32)


def fit_both(s, x, y, nv):
    fit = jax.jit(jax.vmap(jsplines.fit_natural))
    jx = fit(jnp.asarray(s), jnp.asarray(x), jnp.asarray(nv))
    jy = fit(jnp.asarray(s), jnp.asarray(y), jnp.asarray(nv))
    px, py = splines.fit_xy(t(s), t(x), t(y), t(nv))
    return (jx, jy), (px, py)


# -------------------------------- geometry ----------------------------------

def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(-20, 20, (5, 64)).astype(np.float32)
    close(geometry.constrain_angle(t(a)), jgeometry.constrain_angle(a), 0)
    args = [rng.uniform(-5, 5, 64).astype(np.float32) for _ in range(6)]
    for fn in ("local_to_global", "global_to_local"):
        got = getattr(geometry, fn)(*map(t, args))
        want = getattr(jgeometry, fn)(*args)
        for g, w in zip(got, want):
            close(g, w, 2e-5)
    close(geometry.distance(*map(t, args[:4])),
          jgeometry.distance(*args[:4]), 1e-6)
    for g, w in zip(geometry.normal_offset(*map(t, args[:4])),
                    jgeometry.normal_offset(*args[:4])):
        close(g, w, 1e-6)


# -------------------------------- splines -----------------------------------

def test_spline_fit_and_evaluation_match_jax(curves):
    x, y, s, nv = curves
    (jx, jy), (px, py) = fit_both(s, x, y, nv)
    for f in ("a", "b", "c"):
        close(getattr(px, f), getattr(jx, f), 2e-5, 1e-4)
    close(px.s_max, jax.vmap(lambda sp: sp.s_max)(jx), 0)
    # Queries inside, at the knots and beyond both ends (extrapolation).
    q = np.linspace(-3.0, float(s.max()) + 5.0, 97, dtype=np.float32)
    qb = np.broadcast_to(q, (3, 97))
    for order in (0, 1, 2):
        want = jax.jit(jax.vmap(lambda sp, qq: jsplines.evaluate(
            sp, qq, order)))(jx, jnp.asarray(qb))
        close(splines.evaluate(px, t(qb), order), want, 5e-4, 1e-4)
    jh = jax.jit(jax.vmap(jsplines.heading))(jx, jy, jnp.asarray(qb))
    jk = jax.jit(jax.vmap(jsplines.curvature))(jx, jy, jnp.asarray(qb))
    close(splines.heading(px, py, t(qb)), jh, 2e-5)
    close(splines.curvature(px, py, t(qb)), jk, 2e-4, 1e-3)
    tbl_j = jax.vmap(jsplines.pack_xy)(jx, jy)
    tbl = splines.pack_xy(px, py)
    # The port's table leads with the knot position the JAX table omits.
    close(tbl[..., 0], s[:, :-1], 0)
    close(tbl[..., 1:], tbl_j, 2e-5, 1e-4)
    want = jax.jit(jax.vmap(jsplines.eval_xy_fused))(jx, jy, tbl_j,
                                                     jnp.asarray(qb))
    for g, w in zip(splines.eval_xy_fused(px, py, tbl, t(qb)), want):
        close(g, w, 5e-4, 1e-4)


def test_spline_projections_match_jax(curves):
    x, y, s, nv = curves
    (jx, jy), (px, py) = fit_both(s, x, y, nv)
    rng = np.random.default_rng(2)
    u = rng.uniform(2.0, 20.0, 3).astype(np.float32)
    tx = (u + rng.normal(scale=0.5, size=3)).astype(np.float32)
    ty = rng.normal(scale=1.0, size=3).astype(np.float32)
    smax = np.asarray(jax.vmap(lambda sp: sp.s_max)(jx))
    want = jax.vmap(lambda a, b, c, d, m: jsplines.project(a, b, c, d, m))(
        jx, jy, tx, ty, smax)
    close(splines.project(px, py, t(tx), t(ty), t(smax)), want, 1e-3)
    hint = np.asarray(want) + 0.7
    want = jax.vmap(jsplines.project_newton)(jx, jy, tx, ty, smax, hint)
    close(splines.project_newton(px, py, t(tx), t(ty), t(smax), t(hint)),
          want, 1e-3)
    ang = rng.uniform(1.2, 1.9, 3).astype(np.float32)
    want = jax.vmap(jsplines.project_directional_newton)(
        jx, jy, tx, ty, ang, smax, hint)
    got = splines.project_directional_newton(px, py, t(tx), t(ty), t(ang),
                                             t(smax), t(hint))
    close(got, want, 1e-3)
    close(splines.directional_ray_residual(px, py, t(tx), t(ty), t(ang), got),
          jax.vmap(jsplines.directional_ray_residual)(jx, jy, tx, ty, ang,
                                                      want), 1e-3)


def test_spline_padding_helpers_match_jax(curves):
    x, y, s, nv = curves
    close(splines.pad_arclength(t(s), t(nv - 3)),
          jax.vmap(jsplines.pad_arclength)(s, nv - 3), 1e-5)
    want = jax.vmap(lambda a, b: jsplines.pad_polyline(a, b, 16))(
        x[:, :10], y[:, :10])
    for g, w in zip(splines.pad_polyline(t(x[:, :10]), t(y[:, :10]), 16),
                    want):
        close(g, w, 1e-4)


def test_spline_gather_ignores_nonfinite_padding(curves):
    """Padded rows may hold non-finite coefficients; a query in the valid
    range must never read them (the JAX package's invariant)."""
    x, y, s, nv = curves
    _, (px, _) = fit_both(s, x, y, nv)
    ref = splines.evaluate(px, t(s[:, :20]))
    bad = dataclasses.replace(px, a=px.a.clone(), b=px.b.clone())
    for b, n in enumerate(nv):
        bad.a[b, n - 1:] = torch.nan
        bad.b[b, n - 1:] = torch.inf
    out = splines.evaluate(bad, t(s[:, :20]))
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)


# ------------------------- B-spline and segmentation -------------------------

def test_bspline_and_segmentation_match_jax():
    arr = scenarios.adversarial_arrays(8)
    rx, ry, nr = arr["raw_x"], arr["raw_y"], arr["n_raw"]
    rx[5, 3] += 0.8            # bend one route so the fit is not a line
    ry[6, 4] -= 1.1
    n = JCFG.bspline_samples
    want = jax.jit(jax.vmap(lambda a, b, c: jbspline.fit_and_sample(
        a, b, c, n)))(rx, ry, nr)
    got = bspline.fit_and_sample(t(rx), t(ry), t(nr), n)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    m = np.arange(n)[None] < np.asarray(want[3])[:, None]
    for g, w in zip(got[:3], want[:3]):
        close(np.where(m, g.numpy(), 0), np.where(m, w, 0), 2e-4)

    xb, yb, sb, nb = (np.asarray(a) for a in want)
    P = JCFG.n_segment_points
    seg_j = jax.jit(jax.vmap(lambda a, b, c, d: jsegment(a, b, c, d, P)))(
        xb, yb, sb, nb)
    seg_p = segment_raw_reference(t(xb), t(yb), t(sb), t(nb), P)
    np.testing.assert_array_equal(seg_p[5].numpy(), np.asarray(seg_j[5]))
    m = np.arange(P)[None] < np.asarray(seg_j[5])[:, None]
    for name, g, w, tol in zip(("x", "y", "s", "angle", "k"), seg_p[:5],
                               seg_j[:5], (1e-4, 1e-4, 1e-5, 1e-5, 1e-4)):
        close(np.where(m, g.numpy(), 0), np.where(m, w, 0), tol)


# --------------------------------- the map ----------------------------------

def test_edt_matches_scipy_and_jax():
    rng = np.random.default_rng(3)
    mask = rng.random((37, 53)) < 0.04
    mask[10:14, 20:30] = True
    want = ndimage.distance_transform_edt(~mask)
    got = maps.euclidean_distance_transform(torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(got, np.float32(want))
    np.testing.assert_array_equal(
        got, np.asarray(jmaps.euclidean_distance_transform(jnp.asarray(mask))))


def test_adversarial_map_and_lookup_match_jax():
    mask = scenarios.adversarial_mask()
    gm_j = jmaps.build_map(jnp.asarray(mask), resolution=0.2,
                           pad_shape=scenarios.PAD_SHAPE)
    gm = maps.build_map(mask, resolution=0.2, pad_shape=scenarios.PAD_SHAPE,
                        device="cpu")
    np.testing.assert_array_equal(gm.esdf.numpy(), np.asarray(gm_j.esdf))
    np.testing.assert_array_equal(gm.quad.numpy(), np.asarray(gm_j.quad))
    assert (gm.n_rows, gm.n_cols) == (gm_j.n_rows, gm_j.n_cols)
    assert gm.half_extent == tuple(float(h) for h in gm_j.half_extent)
    # Inside, on the edge, just outside and far outside the 60 m map.
    rng = np.random.default_rng(4)
    px = np.concatenate([rng.uniform(-29.9, 29.9, 400),
                         [30.0, -30.0, 30.0, 0.0, 30.05, -30.2, 55.0, 0.0]])
    py = np.concatenate([rng.uniform(-29.9, 29.9, 400),
                         [0.0, 12.3, 30.0, -30.0, 0.0, 5.0, 0.0, -41.0]])
    px, py = px.astype(np.float32), py.astype(np.float32)
    close(maps.obstacle_distance(gm, t(px), t(py)),
          jmaps.obstacle_distance(gm_j, px, py), 1e-5)
    np.testing.assert_array_equal(maps.is_inside(gm, t(px), t(py)).numpy(),
                                  np.asarray(jmaps.is_inside(gm_j, px, py)))
    outside = ~maps.is_inside(gm, t(px), t(py))
    assert int(outside.sum()) == 4
    assert torch.all(maps.obstacle_distance(gm, t(px), t(py))[outside] == 0)
    for g, w in zip(maps.position_to_index(gm, t(px), t(py)),
                    jmaps.position_to_index(gm_j, px, py)):
        close(g, w, 1e-4)


def test_map_from_image_and_from_esdf_match_jax():
    """The image entry point (0 = obstacle) and the precomputed-ESDF entry
    point, zero-padded to a canonical shape, as the JAX package builds
    them; a pad smaller than the map is refused."""
    rng = np.random.default_rng(6)
    img = np.where(rng.random((23, 31)) < 0.08, 0, 255).astype(np.uint8)
    gm_j = jmaps.grid_map_from_image(img, resolution=0.25, pad_shape=(24, 32))
    gm = maps.grid_map_from_image(img, resolution=0.25, pad_shape=(24, 32),
                                  device="cpu")
    np.testing.assert_array_equal(gm.esdf.numpy(), np.asarray(gm_j.esdf))
    assert (gm.n_rows, gm.n_cols, gm.resolution) == (23, 31, 0.25)
    esdf = np.array(gm_j.esdf)[:23, :31]
    wrapped = maps.from_esdf(esdf, resolution=0.25, pad_shape=(24, 32),
                             device="cpu")
    np.testing.assert_array_equal(wrapped.quad.numpy(), np.asarray(gm_j.quad))
    with pytest.raises(ValueError, match="smaller"):
        maps.from_esdf(esdf, pad_shape=(20, 32), device="cpu")
