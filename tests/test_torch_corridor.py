"""The port's corridor, reference resampling and collision bounds against
the JAX package's, on the adversarial map with one route per lane.

The DP lattice is compared field by field; the corridor finish, the DP pass
and the bounds are fed the JAX package's own lattice and reference states
(``convert``), so a difference upstream cannot mask one here. The JAX
functions are per scenario and run under ``jax.vmap``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt import bounds as jbounds
from tpu_pathopt import corridor as jcorridor
from tpu_pathopt import maps as jmaps
from tpu_pathopt import refpath as jrefpath
from tpu_pathopt import splines as jsplines
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import (bounds, convert, corridor, maps, refpath,
                               scenarios, splines)
from tpu_pathopt_torch.config import PlannerConfig

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


def fit_both(s, x, y, nv):
    fit = jax.jit(jax.vmap(jsplines.fit_natural))
    jx = fit(jnp.asarray(s), jnp.asarray(x), jnp.asarray(nv))
    jy = fit(jnp.asarray(s), jnp.asarray(y), jnp.asarray(nv))
    px, py = splines.fit_xy(t(s), t(x), t(y), t(nv))
    return (jx, jy), (px, py)


@pytest.fixture(scope="module")
def lane_routes():
    """The adversarial map and four of its routes (one per lane) as fitted
    reference splines, in both packages."""
    mask = scenarios.adversarial_mask()
    gm_j = jmaps.build_map(jnp.asarray(mask), resolution=0.2,
                           pad_shape=scenarios.PAD_SHAPE)
    gm = maps.build_map(mask, resolution=0.2, pad_shape=scenarios.PAD_SHAPE,
                        device="cpu")
    arr = scenarios.adversarial_arrays(4)
    M = 40
    x = np.linspace(-25.0, 25.0, M, dtype=np.float32)[None].repeat(4, 0)
    y = arr["raw_y"][:, :1].repeat(M, 1) + 0.3 * np.sin(x / 7.0)
    y = y.astype(np.float32)
    s = np.concatenate([np.zeros((4, 1)), np.cumsum(
        np.hypot(np.diff(x), np.diff(y)), -1)], -1).astype(np.float32)
    nv = np.full(4, M, np.int32)
    (jx, jy), (px, py) = fit_both(s, x, y, nv)
    return gm_j, gm, arr, (jx, jy), (px, py), s[:, -1]


def test_prepare_lattice_and_finish_corridor_match_jax(lane_routes):
    gm_j, gm, arr, (jx, jy), (px, py), length = lane_routes
    st = arr["start"]
    length = length + 3.0
    lat_j = jax.jit(jax.vmap(lambda a, b, c, d, e, f: jcorridor.prepare_lattice(
        gm_j, a, b, c, d, e, f, JCFG)))(jx, jy, length, st[:, 0], st[:, 1],
                                        st[:, 2])
    lat = corridor.prepare_lattice(gm, px, py, t(length), t(st[:, 0]),
                                   t(st[:, 1]), t(st[:, 2]), CFG)
    want, got = fields(lat_j), fields(lat)
    for name in ("n_layers", "ok", "cost0"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # The rough bounds are lattice offsets (0.6 m apart) picked by
    # feasibility; XLA's fused arithmetic rounds the offsets by an ulp.
    for name in ("rough_lb", "rough_ub"):
        close(got[name], want[name], 1e-5)
    for name in ("layers_s", "vehicle_l", "ref_x", "ref_y", "ref_h", "dir0"):
        close(got[name], want[name], 1e-4)
    close(got["dir_all"], want["dir_all"], 1e-4)
    fin = want["base_all"] < 1e29
    np.testing.assert_array_equal(got["base_all"] < 1e29, fin)
    close(got["base_all"][fin], want["base_all"][fin], 1e-3)

    # The finish from the JAX package's own lattice and DP pass.
    dp_j = jax.jit(lambda la: jcorridor.dp_forward_batched(la, JCFG))(lat_j)
    cor_j = jax.jit(jax.vmap(lambda la, c, p, a: jcorridor.finish_corridor(
        gm_j, la, c, p, a, JCFG)))(lat_j, *dp_j)
    lat_from_j = convert.dp_lattice(want, "cpu")
    dp = corridor.dp_forward_batched(lat_from_j, CFG)
    # Costs as tests/test_corridor.py holds the Pallas kernel to the scan;
    # parents and alive flags exactly.
    close(dp[0], dp_j[0], 1e-5, 1e-6)
    np.testing.assert_array_equal(dp[1].numpy(), np.asarray(dp_j[1]))
    np.testing.assert_array_equal(dp[2].numpy(), np.asarray(dp_j[2]))
    cor = corridor.finish_corridor(gm, lat_from_j, *dp, CFG)
    for name, w in fields(cor_j).items():
        g = getattr(cor, name).numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            close(g, w, 1e-5)


def test_reference_and_bounds_match_jax(lane_routes):
    gm_j, gm, arr, (jx, jy), (px, py), length = lane_routes
    N = CFG.n_knots
    ref_j = jax.jit(jax.vmap(lambda a, b, m: jrefpath.build_reference_from_spline(
        a, b, m, N, JCFG)))(jx, jy, length)
    ref = refpath.build_reference_from_spline(px, py, t(length), N, CFG)
    want, got = fields(ref_j), fields(ref)
    np.testing.assert_array_equal(got["n_valid"], want["n_valid"])
    np.testing.assert_array_equal(got["truncated"], want["truncated"])
    m = np.arange(N)[None] < want["n_valid"][:, None]
    for name in ("s", "x", "y", "heading", "k"):
        close(np.where(m, got[name], 0), np.where(m, want[name], 0), 2e-4)

    # Bounds on the JAX package's own reference states.
    ref_in = convert.ref_states(want, "cpu")
    cb_j = jax.jit(jax.vmap(lambda a, b, r: jbounds.update_bounds(
        gm_j, a, b, r, JCFG)))(jx, jy, ref_j)
    cb = bounds.update_bounds(gm, px, py, ref_in, CFG)
    wb, gb = fields(cb_j), fields(cb)
    assert set(gb) == set(wb)
    np.testing.assert_array_equal(gb["n_valid"], wb["n_valid"])
    np.testing.assert_array_equal(gb["blocked"], wb["blocked"])
    for name in set(wb) - {"n_valid", "blocked"}:
        d = np.abs(np.where(m, gb[name] - wb[name], 0))
        # A 1e-6 position difference can flip one 0.05 m march step.
        assert d.max() <= 0.05 + 2e-3, name
        assert np.mean(d[m] < 2e-3) >= 0.95, name

    # The easy lane runs through, the dead-end lane is truncated.
    assert not wb["blocked"][0] and wb["blocked"][3]
