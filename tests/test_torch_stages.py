"""The port's pipeline stage by stage against the JAX package's, on the
8-scenario adversarial batch (two per lane) at the default config.

Each port stage is fed the JAX stage's own outputs as its inputs
(``convert``), so every comparison measures that one stage. Tolerances
follow ``tests/test_parity_gridmap.py:134-207``: segmentation 1e-4, the
smoothing QP 2e-2, the corridor exact up to single 0.2 m march steps on a
few layers, post-smoothing 1e-3 (here 5e-3: two float32 ADMM solves at the
2e-3 tolerance, where the gridmap test compares one against a float64
oracle), the reference 2e-3 in heading and 5e-4 in curvature, collision
bounds exact up to single 0.05 m march steps, and both path-QP passes
converged with the same flags and iteration counts within one interval.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import convert, pipeline, splines
from tpu_pathopt_torch.config import PlannerConfig

CFG, JCFG = PlannerConfig(), JaxConfig()
CHECK = CFG.qp_check_every


def t(a):
    return convert.tensor(np.array(a), "cpu")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def maxdiff(got, want, mask=None):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(np.where(mask, d, 0).max() if mask is not None else d.max())


@pytest.fixture(scope="module")
def jax_stages():
    gm, scs, _ = bench.build_adversarial(8)
    st = JCFG.qp_settings()
    S = dict(static_argnames=("config", "settings"))
    prep = jax.jit(jpipe.stage_prep, static_argnames=("config",))(scs, JCFG)
    smooth = jax.jit(jpipe.stage_smooth, **S)(gm, prep, JCFG, st)
    xs2, ys2, cor = jax.jit(jpipe.stage_corridor,
                            static_argnames=("config",))(gm, scs, smooth,
                                                         JCFG)
    post = jax.jit(jpipe.stage_post_smooth, **S)(cor, JCFG, st)
    geo = jax.jit(jpipe.stage_geometry, static_argnames=("config",))(
        gm, scs, xs2, ys2, cor, post[0], JCFG)
    sols = jax.jit(jpipe.stage_path_qp, **S)(scs, geo, JCFG, st)
    out = jax.tree_util.tree_map(
        np.asarray, dict(prep=prep, smooth=smooth, xs2=xs2, ys2=ys2, cor=cor,
                         post=post, geo=geo, sols=sols))
    port_gm = convert.grid_map(dict(esdf=gm.esdf, n_rows=gm.n_rows,
                                    n_cols=gm.n_cols), "cpu")
    return out, port_gm, convert.scenario(fields(scs), "cpu")


def spline(sp):
    return splines.CubicSpline(**{k: t(getattr(sp, k)) for k in
                                  ("s", "y", "a", "b", "c", "n_valid")})


def test_stage_prep(jax_stages):
    j, _, scs = jax_stages
    got = pipeline.stage_prep(scs, CFG)
    want = j["prep"]
    for i in (0, 6):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    m = np.arange(CFG.n_segment_points)[None] < want[6][:, None]
    for i, tol in zip(range(1, 6), (1e-4, 1e-4, 1e-4, 1e-4, 1e-3)):
        assert maxdiff(got[i], want[i], m) < tol, i


def test_stage_smooth(jax_stages):
    j, gm, _ = jax_stages
    got = pipeline.stage_smooth(gm, tuple(t(a) for a in j["prep"]), CFG,
                                CFG.qp_settings())
    want = j["smooth"]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert bool(got[4].all())
    m = np.arange(CFG.n_segment_points)[None] < want[3][:, None]
    for i in range(3):
        assert maxdiff(got[i], want[i], m) < 2e-2, i


def test_stage_corridor(jax_stages):
    j, gm, scs = jax_stages
    xs2, ys2, cor = pipeline.stage_corridor(
        gm, scs, tuple(t(a) for a in j["smooth"]), CFG)
    want = fields(j["cor"])
    got = fields(cor)
    for name in ("n_layers", "ok"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for sp, spj in ((xs2, j["xs2"]), (ys2, j["ys2"])):
        for k in ("s", "y", "a", "b", "c"):
            assert maxdiff(getattr(sp, k), getattr(spj, k)) < 1e-3, k
    assert maxdiff(got["layers_s"], want["layers_s"]) < 1e-3
    assert maxdiff(got["vehicle_l"], want["vehicle_l"]) < 1e-4
    m = np.arange(CFG.dp_layers)[None] < want["n_layers"][:, None]
    for name in ("lower", "upper"):
        d = np.abs(got[name] - want[name])[m]
        assert d.max() < 0.2 + 1e-3, name
        assert np.mean(d < 1e-3) >= 0.8, name


def test_stage_post_smooth(jax_stages):
    j, _, _ = jax_stages
    cor = convert.corridor(fields(j["cor"]), "cpu")
    l_post, ok_post = pipeline.stage_post_smooth(cor, CFG, CFG.qp_settings())
    np.testing.assert_array_equal(ok_post.numpy(), j["post"][1])
    assert maxdiff(l_post, j["post"][0]) < 5e-3


def test_stage_geometry(jax_stages):
    j, gm, scs = jax_stages
    cor = convert.corridor(fields(j["cor"]), "cpu")
    ref, cb, off, herr, ok_init, nv = pipeline.stage_geometry(
        gm, scs, spline(j["xs2"]), spline(j["ys2"]), cor, t(j["post"][0]),
        CFG)
    ref_j, cb_j, off_j, herr_j, ok_init_j, nv_j = j["geo"]
    np.testing.assert_array_equal(nv.numpy(), nv_j)
    np.testing.assert_array_equal(ok_init.numpy(), ok_init_j)
    np.testing.assert_array_equal(cb.blocked.numpy(), cb_j.blocked)
    np.testing.assert_array_equal(ref.truncated.numpy(), ref_j.truncated)
    assert maxdiff(off, off_j) < 1e-3
    assert maxdiff(herr, herr_j) < 2e-3
    m = np.arange(CFG.n_knots)[None] < nv_j[:, None]
    for name, tol in (("s", 1e-3), ("x", 2e-2), ("y", 2e-2),
                      ("heading", 2e-3), ("k", 5e-4)):
        assert maxdiff(getattr(ref, name), getattr(ref_j, name), m) < tol
    for name in ("front_lb", "front_ub", "rear_lb", "rear_ub"):
        d = np.abs(getattr(cb, name).numpy() - getattr(cb_j, name))[m]
        assert d.max() < 0.05 + 2e-3, name
        assert np.mean(d < 2e-3) >= 0.9, name


def test_stage_path_qp_and_finalize(jax_stages):
    j, _, scs = jax_stages
    ref_j, cb_j, *rest = j["geo"]
    geo = (convert.ref_states(fields(ref_j), "cpu"),
           convert.corridor_bounds(fields(cb_j), "cpu"),
           *(t(a) for a in rest))
    sol1, sol2 = pipeline.stage_path_qp(scs, geo, CFG, CFG.qp_settings())
    m = np.arange(CFG.n_knots)[None] < rest[-1][:, None]
    for got, want in zip((sol1, sol2), j["sols"]):
        np.testing.assert_array_equal(got.converged.numpy(), want.converged)
        assert bool(got.converged.all())
        assert np.abs(got.iters.numpy() - want.iters).max() <= CHECK
        assert maxdiff(got.v, want.v, m[..., None]) < 2e-2
    # kappa and the heading error are well determined (gridmap test).
    assert maxdiff(sol2.v[..., 2], j["sols"][1].v[..., 2], m) < 1e-3
    assert maxdiff(sol2.v[..., 1], j["sols"][1].v[..., 1], m) < 5e-3

    outs = pipeline.stage_finalize(geo[0], sol2, geo[-1], CFG)
    want = jpipe.stage_finalize(ref_j, j["sols"][1], rest[-1], JCFG)
    for g, w in zip(outs, want):
        assert maxdiff(g, w, m) < 3e-2
    assert all(torch.isfinite(o).all() for o in outs)
