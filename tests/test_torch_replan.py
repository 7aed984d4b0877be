"""The port's replanning loop (``pipeline.solve_batch_warm``,
``replan.py``) against the JAX package's (``tests/test_replan.py``): the
warm start, the advance along the solved path, the interpolation under it,
and the stream cycle by cycle, on the small config and corridor map of
``tests/test_replan.py``; and the port on the CPU against the replan
fixture (``tests/test_torch_fixtures.py``).

Tolerances: a warm re-solve lands on the cold one as in the JAX test (k
2e-3, d_heading 5e-3, l 5e-2: the QP stops anywhere in its 2e-3 band, and
l sits in a flat valley); the advance to 1e-5 m and rad (the same
interpolation of the same path, float32 round-off); jnp.interp exactly
where it takes an end value or a zero-width interval, to 1e-6 relative
inside an interval; the streams at golden.TOLERANCES, flags exactly and ADMM
counts within one 25-iteration interval per pass.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt import maps as jmaps
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt import replan as jreplan
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import convert, golden, maps, pipeline, replan, \
    scenarios
from tpu_pathopt_torch.config import PlannerConfig

SMALL = dict(n_knots=64, n_segment_points=32, dp_layers=24,
             bspline_samples=64)
CFG, JCFG = PlannerConfig(**SMALL), JaxConfig(**SMALL)


def corridor_mask(dead_end=False):
    res, size = 0.2, 300
    mask = np.zeros((size, size), bool)
    yy = (0.5 * size - 0.5 - np.arange(size)) * res
    xx = (0.5 * size - 0.5 - np.arange(size)) * res
    mask[:, np.abs(yy) >= 12.0] = True
    if dead_end:
        mask[np.abs(xx + 12.0) < 0.5, :] = True     # wall at x = -12
    return mask


def both_maps(dead_end=False):
    mask = corridor_mask(dead_end)
    return (jmaps.build_map(jnp.asarray(mask), resolution=0.2),
            maps.build_map(mask, resolution=0.2, device="cpu"))


def batch_arrays(B=2) -> dict:
    """tests/test_replan.py's batch: a straight 50 m route, starts offset
    laterally in [-1, 1] m."""
    R = 16
    raw_x = np.linspace(-25, 25, 8)
    raw_x = np.concatenate([raw_x, np.full(R - 8, raw_x[-1])])
    f = lambda v: np.full(B, v, np.float32)  # noqa: E731
    return dict(raw_x=np.tile(raw_x, (B, 1)).astype(np.float32),
                raw_y=np.zeros((B, R), np.float32),
                n_raw=np.full(B, 8, np.int32), start_x=f(-25.0),
                start_y=np.linspace(-1.0, 1.0, B).astype(np.float32),
                start_heading=f(0.0), start_k=f(0.0), target_x=f(25.0),
                target_y=f(0.0), target_heading=f(0.0))


def both_batches(B=2):
    d = batch_arrays(B)
    return (jpipe.Scenario(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.scenario(d, "cpu"))


@pytest.fixture(scope="module")
def corridor_maps():
    return both_maps()


def test_warm_resolve_matches_cold(corridor_maps):
    """Re-solving the same query warm-started lands on the cold solution
    within the solver tolerance and iterates no more."""
    _, gm = corridor_maps
    _, scs = both_batches(2)
    res_cold, warm = pipeline.solve_batch_warm(gm, scs, CFG, device="cpu")
    assert bool(res_cold.ok.all()) and bool(warm.valid.all())
    res_warm, warm2 = pipeline.solve_batch_warm(gm, scs, CFG, warm=warm,
                                                device="cpu")
    assert bool(res_warm.ok.all()) and bool(warm2.valid.all())
    nv = int(res_cold.n_valid[0])
    for name, atol in (("k", 2e-3), ("d_heading", 5e-3), ("l", 5e-2)):
        np.testing.assert_allclose(getattr(res_warm, name)[:, :nv].numpy(),
                                   getattr(res_cold, name)[:, :nv].numpy(),
                                   atol=atol, err_msg=name)
    assert int(res_warm.qp_iters.sum()) <= int(res_cold.qp_iters.sum())
    # The carried state is pass 2's: its rho is a per-lane adapted value.
    assert warm.v.shape == (2, CFG.n_knots, 6)
    assert warm.rho_bar.shape == (2,) and bool((warm.rho_bar > 0).all())


def test_port_warm_started_from_the_jax_state_matches_jax(corridor_maps):
    """The port's solve seeded with the JAX package's own QPWarmStart
    (``convert.qp_warm_start``) against the JAX warm solve: flags equal,
    ADMM counts within one interval per pass, paths within
    golden.TOLERANCES."""
    gm_j, gm = corridor_maps
    scs_j, scs = both_batches(2)
    _, warm_j = jpipe.solve_batch_warm(gm_j, scs_j, JCFG)
    want, _ = jpipe.solve_batch_warm(gm_j, scs_j, JCFG, warm=warm_j)
    warm = convert.qp_warm_start(
        {f.name: np.asarray(getattr(warm_j, f.name))
         for f in dataclasses.fields(warm_j)}, "cpu")
    assert bool(warm.valid.all()) and warm.v.dtype == torch.float32
    got, _ = pipeline.solve_batch_warm(gm, scs, CFG, warm=warm, device="cpu")
    failures, diffs = golden.compare(golden.arrays(got), golden.arrays(want))
    assert not failures, (failures, diffs)


def test_cold_warm_start_equals_no_warm_start(corridor_maps):
    """A warm start whose lanes are all invalid seeds pass 1 exactly as no
    warm start does: zeros and the configured rho."""
    _, gm = corridor_maps
    _, scs = both_batches(2)
    a = pipeline.solve_batch(gm, scs, CFG, device="cpu")
    junk = pipeline.QPWarmStart.cold(2, CFG, "cpu")
    junk = dataclasses.replace(junk, v=junk.v + 3.0, rho_bar=junk.rho_bar + 7)
    b, _ = pipeline.solve_batch_warm(gm, scs, CFG, warm=junk, device="cpu")
    for f in golden.PATH_FIELDS + ("qp_iters",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("ds", [2.0, 500.0])
def test_advance_scenarios_matches_jax(ds):
    """The advance along a path truncated by a dead-end wall, fed the same
    JAX PathResult, equals the JAX package's to 1e-5 m and rad, including
    a query far past the end, which lands on the last valid knot."""
    gm_j, _ = both_maps(dead_end=True)
    scs_j, scs = both_batches(2)
    res_j = jpipe.solve_batch_jit(gm_j, scs_j, JCFG)
    assert bool(jnp.all(res_j.ok)) and bool(jnp.all(res_j.n_valid < 64))
    want = jreplan.advance_scenarios(scs_j, res_j, ds)
    d = {f.name: np.asarray(getattr(res_j, f.name))
         for f in dataclasses.fields(res_j) if f.name != "bounds"}
    got = replan.advance_scenarios(scs, convert.path_result(d, "cpu"), ds)
    for f in golden.POSE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(got.raw_x.numpy(), scs.raw_x.numpy())
    if ds > 100:
        nv = d["n_valid"]
        for b in range(2):
            assert abs(float(got.start_x[b]) - d["x"][b, nv[b] - 1]) < 1e-4
            assert abs(float(got.start_y[b]) - d["y"][b, nv[b] - 1]) < 1e-4


def test_advance_keeps_failed_lanes_in_place():
    _, scs = both_batches(2)
    N = 8
    s = torch.arange(N, dtype=torch.float32)[None].expand(2, N)
    res = convert.path_result(dict(
        x=s.numpy() + 5.0, y=np.zeros((2, N)), heading=np.zeros((2, N)),
        l=np.zeros((2, N)), d_heading=np.zeros((2, N)),
        k=np.full((2, N), 0.1), d_k=np.zeros((2, N)), s=s.numpy(),
        n_valid=np.array([N, N]), ok=np.array([True, False]),
        blocked=np.zeros(2, bool), qp_iters=np.zeros(2, int),
        ok_input=np.ones(2, bool), ok_smooth=np.ones(2, bool),
        ok_corridor=np.ones(2, bool), ok_post=np.ones(2, bool),
        ok_init=np.ones(2, bool), ok_qp=np.ones(2, bool),
        horizon_truncated=np.zeros(2, bool)), "cpu")
    got = replan.advance_scenarios(scs, res, 2.5)
    assert got.start_x.tolist() == [7.5, -25.0]
    assert got.start_k.tolist()[1] == 0.0
    assert abs(got.start_k.tolist()[0] - 0.1) < 1e-7


def test_interp_matches_jnp_interp():
    """replan.interp equals jnp.interp row by row: exactly at repeated
    abscissae (a zero-width interval gives its left value; a right-sided
    search lands past the repeats) and out of range (the end values), and
    to 1e-6 relative inside intervals."""
    rng = np.random.default_rng(0)
    B, N = 6, 12
    xp = np.sort(rng.uniform(0, 10, (B, N)), axis=1).astype(np.float32)
    xp[:, 4] = xp[:, 3]                       # a repeated abscissa
    xp[:, 8:11] = xp[:, 7:8]                  # three repeats
    fp = rng.normal(size=(B, N)).astype(np.float32)
    special = np.stack([xp[:, 3], xp[:, 7], xp[:, 0], xp[:, -1],
                        xp[:, 0] - 1.0, xp[:, -1] + 3.0], 1)
    inner = (xp[:, :-1] + xp[:, 1:]) / 2
    for q, exact in ((special, True), (inner, False)):
        for j in range(q.shape[1]):
            want = np.array([np.asarray(jnp.interp(q[b, j], xp[b], fp[b]))
                             for b in range(B)])
            got = replan.interp(torch.as_tensor(q[:, j].copy()),
                                torch.as_tensor(xp), torch.as_tensor(fp))
            if exact:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6)


def test_stream_matches_jax_cycle_by_cycle(corridor_maps):
    """Three warm cycles of the port (CPU) and of the JAX package: each
    cycle's flags equal, ADMM counts within one interval per pass, paths
    and advanced poses within golden.TOLERANCES."""
    gm_j, gm = corridor_maps
    scs_j, scs = both_batches(2)
    want = golden.replan_arrays(
        lambda s, w: jreplan.replan_step(gm_j, s, w, JCFG, None, 1.0),
        scs_j, jpipe.QPWarmStart.cold(2, JCFG))
    got = golden.replan_arrays(
        lambda s, w: replan.replan_step(gm, s, w, CFG, None, 1.0,
                                        device="cpu"),
        scs, pipeline.QPWarmStart.cold(2, CFG, "cpu"))
    failures, diffs = golden.compare_replan(got, want)
    assert not failures, (failures, diffs)
    assert all(bool(got[f"c{c}.ok"].all()) for c in range(3))


def test_warm_stream_iterates_no_more_than_cold(corridor_maps):
    """Every cycle of both streams succeeds; cycle 0 is cold in both, and
    the warm cycles take no more ADMM iterations than the cold ones. Each
    cycle's result reaches ``consume``."""
    _, gm = corridor_maps
    seen = []
    warm = replan.replan_stream(gm, both_batches(2)[1], CFG, n_steps=4,
                                device="cpu", consume=seen.append)
    cold = replan.replan_stream(gm, both_batches(2)[1], CFG, n_steps=4,
                                use_warm=False, device="cpu")
    assert len(seen) == 4 and all(bool(r.ok.all()) for r in seen)
    for st in (warm, cold):
        assert st.n_ok == st.n_total == 8 and st.n_steps == 4
    assert warm.mean_iters_first == cold.mean_iters_first
    assert warm.mean_iters_rest <= cold.mean_iters_rest
    with pytest.raises(ValueError):
        replan.replan_stream(gm, both_batches(2)[1], CFG, n_steps=0,
                             device="cpu")


def test_port_matches_replan_fixture_on_cpu():
    """The port's warm stream on the golden batch at the default config,
    on the CPU, against the JAX package's stored stream."""
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    cfg = PlannerConfig(**golden.CONFIGS["replan"])
    got = golden.replan_arrays(
        lambda s, w: replan.replan_step(gm, s, w, cfg, None,
                                        golden.REPLAN_DS, device="cpu"),
        scs, pipeline.QPWarmStart.cold(golden.BATCH, cfg, "cpu"))
    failures, diffs = golden.compare_fixture(
        "replan", got, golden.load(golden.FIXTURES["replan"]))
    assert not failures, (failures, diffs)
