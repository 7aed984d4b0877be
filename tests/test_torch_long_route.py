"""The long route against the JAX package: the shapes past one thread block
of K2 and K3 and past 119 laterals of K4, and the whole route at 512 knots.

- K2's plain round at a ragged N = 300 (B = 2, 5 iterations) against the
  JAX Pallas round in interpret mode, at the round tolerances of
  ``tests/test_fused_rounds.py``; on the card the round takes a cluster of
  two CTAs of 150 knots (``fused_rounds.round_plan``).
- K4's plain forward pass at 135 laterals against the JAX Pallas forward
  in interpret mode and the JAX scan: parents and alive flags bit for bit,
  costs within 1e-5 (on the card the kernel reads the layer tables from
  device memory there).
- K3 at (9, 9) on ``chip_smoke.conditioned_tension_round`` at 200 groups,
  where the card holds it: the Pallas kernel's order and a model of the
  CUDA kernel's sweep order stay within ``chip_smoke.TOLERANCE`` of the
  plain round.
- ``solve_batch`` on the long fixture's 8 scenarios
  (``scenarios.build_long_route``, 120 m routes on a 701 x 710 map at
  0.2 m) at ``scenarios.LONG_CONFIG`` (512 knots) against
  ``jax_long_b8.npz`` at ``golden.TOLERANCES``, with no lane but the
  blocked one truncated.
- The fixture regenerates from the JAX package's TPU path, and a 1e-7
  relative change of its raw points moves that result by no more than
  ``golden.TOLERANCES`` (marked slow: three solves in interpret mode).

``chip_smoke`` holds the cluster path to the one-CTA path on rounds cut to
128 and 256 knots, which :func:`test_cut_factor_is_the_factor_of_the_cut`
shows are rounds of the cut QPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt import corridor as jcorridor
from tpu_pathopt import maps as jmaps
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import fused_rounds as jfused
from tpu_pathopt_torch import corridor, golden, maps, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.solver import fused_rounds

from test_torch_fixtures import assert_regenerates, jax_long_arrays
from test_torch_kernels import (ROUND_TOL, ST, assert_close, chicane_qps,
                                kernel_order_solve, lane,
                                pallas_structured_round, path_factors,
                                random_lattice, t)


def k2_case(n: int, iters: int):
    """A mid-solve K2 round on two chicane QPs of n knots: (the torch
    wrapper's arguments, the Pallas kernel's result in interpret mode)."""
    qp = chicane_qps([0.8, -0.5], n=n)
    B, N = qp.p_diag.shape[:2]
    rk, re, diag, offp = path_factors(qp)
    ci_l, wp_l = jfused.fused_factor(lane(diag), lane(offp), interpret=True)
    lbk, ubk, lbe, ube = jax.vmap(jassembly.bounds)(qp)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(scale=0.1, size=(B, N, 6)), jnp.float32)
    zk, ze = jax.vmap(jassembly.a_mul)(qp, v)
    yk = jnp.asarray(rng.normal(scale=0.05, size=(B, N, 6)), jnp.float32)
    ye = jnp.asarray(rng.normal(scale=0.05, size=(B, 2)), jnp.float32)
    geom = qp.coll_coef[:1, 0, :, 1]
    es = lane((jnp.arange(N)[None, :] == qp.end_idx[:, None])
              .astype(jnp.float32))[:, None, :]
    want = jfused.fused_admm_round(
        geom, ci_l, wp_l, lane(qp.t_prev), lane(lbk), lane(ubk), lane(lbe),
        lane(ube), lane(rk), lane(re), es, lane(qp.p_diag), lane(v),
        lane(zk), lane(ze), lane(yk), lane(ye), iters=iters, alpha=ST.alpha,
        sigma=ST.sigma, interpret=True)
    args = (fused_rounds.collision_rows(t(qp.coll_coef)), t(ci_l),
            t(wp_l), t(lane(qp.t_prev)), t(lane(lbk)), t(lane(ubk)),
            t(lane(lbe)), t(lane(ube)), t(lane(rk)), t(lane(re)),
            t(qp.end_idx).to(torch.int32),
            t(lane(qp.p_diag)), t(lane(v)), t(lane(zk)), t(lane(ze)),
            t(lane(yk)), t(lane(ye)), iters, ST.alpha, ST.sigma)
    return args, want


def test_k2_round_plain_matches_pallas_at_300_knots():
    args, want = k2_case(300, 5)
    assert args[1].shape == (300, 6, 6, 2)
    assert fused_rounds.round_plan("fused_admm_round", 300) == (2, 150,
                                                                35416)
    got = fused_rounds.fused_admm_round(*args)
    for a, b in zip(got, want):
        assert a.shape == tuple(b.shape)
        assert_close(a, b, ROUND_TOL)


def test_k4_plain_matches_pallas_and_scan_at_135_laterals():
    w1 = JaxConfig().dp_weight_angle_change
    arrs = random_lattice(seed=11, B=2, lm1=6, K=135)
    j = tuple(jnp.asarray(a) for a in arrs)
    pallas = jcorridor._dp_forward_pallas(*j, w1, interpret=True)
    scan = jax.vmap(lambda d, b, h, c0, d0: jcorridor._dp_forward_scan(
        d, b, h, c0, d0, w1))(*j)
    got = corridor.dp_forward(*(t(a) for a in arrs), w1)
    assert got[1].shape == (2, 6, 135) and bool(got[2].any())
    for want in (pallas, scan):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("order", ["pallas", "kernel_order"])
def test_k3_conditioned_round_at_200_groups_is_held(order, monkeypatch):
    """chip_smoke's (9, 9) round at WIDE_GROUPS groups, on a curve of
    WIDE_LENGTH m (the main path's spacing over 200 groups would put the
    coordinates at 117 m, where float32 rounding in another order alone
    moves the round beyond TOLERANCE), is one other float32 orders agree
    on; on the card it takes a cluster of two CTAs."""
    from chip_smoke import (TOLERANCE, WIDE_GROUPS, WIDE_LENGTH, compare,
                            conditioned_tension_round)
    args = conditioned_tension_round(4, "cpu", groups=WIDE_GROUPS,
                                     length=WIDE_LENGTH)
    assert args[0].shape == (WIDE_GROUPS, 9, 9, 4)
    assert fused_rounds.round_plan("fused_structured_round", WIDE_GROUPS, 9,
                                   9).cluster == 2
    plain = fused_rounds.structured_round_plain(*args)
    if order == "pallas":
        other = pallas_structured_round(args)
    else:
        monkeypatch.setattr(fused_rounds.btridiag, "solve_batched",
                            kernel_order_solve)
        other = fused_rounds.structured_round_plain(*args)
    cmp = compare("fused_structured_round", other, plain)
    assert TOLERANCE["fused_structured_round"] == (5e-3, 5e-3)
    assert cmp["within_tol"], cmp


def test_cut_factor_is_the_factor_of_the_cut():
    """K1's plain factor of a path QP's first n knots equals the first n
    knots of the factor of the whole QP, bit for bit: a round cut to n
    knots (chip_smoke.cut_knots) is a round of the cut QP."""
    qp = chicane_qps([0.6, -0.3], n=40)
    _, _, diag, offp = path_factors(qp)
    dl, ol = t(lane(diag)), t(lane(offp))
    whole = fused_rounds.factor_plain(dl, ol)
    cut = fused_rounds.factor_plain(dl[:25].contiguous(),
                                    ol[:25].contiguous())
    for w, c in zip(whole, cut):
        assert torch.equal(w[:25], c)


def test_long_route_map_and_batch():
    """The long route: a 701 x 710 map at 0.2 m that PAD_SHAPE holds, the
    same ESDF in both packages, 120 m routes a quarter per lane."""
    mask = scenarios.long_route_mask()
    assert mask.shape == scenarios.LONG_SHAPE == (701, 710)
    port = maps.build_map(mask, resolution=0.2, pad_shape=scenarios.PAD_SHAPE,
                          device="cpu")
    jgm = jmaps.build_map(jnp.asarray(mask), resolution=0.2,
                          pad_shape=scenarios.PAD_SHAPE)
    np.testing.assert_array_equal(port.esdf.numpy(), np.asarray(jgm.esdf))
    arr = scenarios.long_route_arrays(8)
    assert (arr["start"][:, 0] == -60).all() and (arr["target"][:, 0]
                                                   == 60).all()
    np.testing.assert_array_equal(arr["target"][::2, 1],
                                  np.float32(scenarios.LANE_Y))


def test_port_matches_long_fixture_on_cpu():
    """solve_batch at 512 knots on the long fixture's scenarios against the
    JAX package's TPU path: every flag equal, the paths at
    golden.TOLERANCES, every scenario ok and none off the blocked lane
    truncated."""
    gm, scs = golden.fixture_batch("long", "cpu")
    cfg = PlannerConfig(**golden.CONFIGS["long"])
    assert cfg.n_knots == 512
    want = golden.load(golden.FIXTURES["long"])
    got = golden.arrays(pipeline.solve_batch(gm, scs, cfg, device="cpu"))
    failures, diffs = golden.compare_fixture("long", got, want)
    assert not failures, (failures, diffs)
    assert "long" not in golden.FIXTURE_TOLERANCES
    assert "long" not in golden.PATH_LANES
    assert got["ok"].all() and not got["horizon_truncated"].any()
    assert (got["n_valid"][:6] > 380).all()      # 120 m at 0.3 m a knot


@pytest.mark.slow
def test_long_fixture_regenerates_and_the_jax_result_is_stable():
    """The long fixture regenerates; and the JAX package's own result on
    it moves by no more than golden.TOLERANCES under a relative -1e-7 and
    +1e-7 change of the raw points (with 9 slalom posts from x = -50 its
    slalom lane moved by 100 ADMM iterations and 0.55 m of bound)."""
    want = golden.load(golden.FIXTURES["long"])
    got, lo, hi = jax_long_arrays(scales=(1.0, 1 - 1e-7, 1 + 1e-7))
    assert_regenerates(got, want)
    for moved in (lo, hi):
        failures, diffs = golden.compare(moved, want)
        assert not failures, (failures, diffs)
