"""Two planner knobs of the port against the JAX package:
``rough_constraints_far_away`` (the reference's rough rows beyond
``precise_planning_length``, through K2) and ``QPSettings.pscan``
(``tests/test_torch_prescan.py`` holds the third,
``directional_prescan_fallback``).

Under the rough rows each knot's collision rows differ, and the JAX
package's Pallas round kernel hard-codes the default ones: the round test
here shows it departing from the JAX XLA round, which iterates the QP that
was factored, while the port's plain K2 round (the function its CUDA kernel
is held to) agrees with the XLA round. The port is held to the XLA path
under this setting, end to end too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_kernels as tk
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import btridiag as jbtridiag
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import fused_rounds as jfused
from tpu_pathopt_torch import convert, golden, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.solver import fused_rounds, path_solver

ST = tk.ST
ROUND_TOL = tk.ROUND_TOL
lane, t = tk.lane, tk.t


# ---------------------------- rough far-away rows ----------------------------

def rough_qps(shifts, n=16, precise=2.0):
    """tests/test_torch_kernels.py's chicane path QPs with the rough rows
    beyond ``precise`` m (knots 7..15 of 16 at 0.3 m)."""
    cfg = JaxConfig(n_knots=n, rough_constraints_far_away=True,
                    precise_planning_length=precise)
    s = jnp.arange(n, dtype=jnp.float32) * 0.3
    k = jnp.zeros(n)

    def mk(shift):
        c = jnp.where((s > 3.0) & (s < 6.0), shift, 0.0)
        return jassembly.assemble_path_qp(
            ref_s=s, ref_k=k, ref_heading_last=0.0,
            input_l=jnp.zeros(n), input_e=jnp.zeros(n), input_k=k,
            front_lb=c - 1.2, front_ub=c + 1.2, rear_lb=c - 1.2,
            rear_ub=c + 1.2, init_offset=0.0, init_heading_error=0.0,
            start_k=0.0, target_heading=0.0, blocked=False, n_valid=n,
            config=cfg, center_lb=c - 1.0, center_ub=c + 1.0)

    return jax.vmap(mk)(jnp.asarray(shifts, jnp.float32))


def xla_round(qp, Ci, W, state, rk, re, bnd):
    """check_every iterations of the JAX package's XLA round
    (path_solver._solve_chunk_xla's step) and its residuals, on the
    inverted factors Ci (B, N, 6, 6), W (B, N-1, 6, 6)."""
    a_mul, at_mul = jax.vmap(jassembly.a_mul), jax.vmap(jassembly.at_mul)
    lbk, ubk, lbe, ube = bnd
    for _ in range(ST.check_every):
        v, zk, ze, yk, ye = state
        rhs = ST.sigma * v + at_mul(qp, rk * zk - yk, re * ze - ye)
        vt = jbtridiag.solve_batched(Ci, W, rhs)
        ztk, zte = a_mul(qp, vt)
        ztmp_k = ST.alpha * ztk + (1 - ST.alpha) * zk + yk / rk
        ztmp_e = ST.alpha * zte + (1 - ST.alpha) * ze + ye / re
        zk_n, ze_n = jnp.clip(ztmp_k, lbk, ubk), jnp.clip(ztmp_e, lbe, ube)
        state = (ST.alpha * vt + (1 - ST.alpha) * v, zk_n, ze_n,
                 rk * (ztmp_k - zk_n), re * (ztmp_e - ze_n))
    v, zk, ze, yk, ye = state
    Avk, Ave = a_mul(qp, v)
    pv, Aty = qp.p_diag * v, at_mul(qp, yk, ye)
    amax = lambda a: jnp.max(jnp.abs(a.reshape(a.shape[0], -1)), -1)  # noqa
    inf2 = lambda a, b: jnp.maximum(amax(a), amax(b))  # noqa: E731
    res = jnp.stack([inf2(Avk - zk, Ave - ze), amax(pv + Aty),
                     jnp.maximum(inf2(Avk, Ave), inf2(zk, ze)),
                     jnp.maximum(amax(pv), amax(Aty))])
    return tuple(lane(a) for a in state) + (res,)


def departs(got, want, tol):
    """Some element outside |got - want| <= atol + rtol |want| (NaN is)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return not np.isclose(g, w, atol=tol["atol"], rtol=tol["rtol"]).all()


def test_pallas_k2_departs_from_the_xla_round_on_rough_rows_the_port_not():
    """One mid-solve round of rough path QPs from the same factors and
    iterate: the JAX Pallas K2 (interpret mode) departs from the JAX XLA
    round beyond ROUND_TOL in every output (it iterates the rows of
    coll_coef[:1, 0] at every knot; here it ends in NaN), while the port's
    K2 on CPU tensors (its plain round, built from each knot's rows) stays
    within ROUND_TOL of the XLA round."""
    qp = rough_qps([0.8, -0.5, 0.0])
    cc = np.asarray(qp.coll_coef)
    assert not (cc == cc[:1, :1]).all()          # the rows differ by knot
    B, N = qp.p_diag.shape[:2]
    rk, re, diag, offp = tk.path_factors(qp)
    ci_l, wp_l = jfused.fused_factor(lane(diag), lane(offp), interpret=True)
    bnd = jax.vmap(jassembly.bounds)(qp)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(scale=0.1, size=(B, N, 6)), jnp.float32)
    zk, ze = jax.vmap(jassembly.a_mul)(qp, v)
    yk = jnp.asarray(rng.normal(scale=0.05, size=(B, N, 6)), jnp.float32)
    ye = jnp.asarray(rng.normal(scale=0.05, size=(B, 2)), jnp.float32)
    state = (v, zk, ze, yk, ye)
    es = lane((jnp.arange(N)[None, :] == qp.end_idx[:, None])
              .astype(jnp.float32))[:, None, :]
    pallas = jfused.fused_admm_round(
        qp.coll_coef[:1, 0, :, 1], ci_l, wp_l, lane(qp.t_prev),
        *(lane(a) for a in bnd), lane(rk), lane(re), es, lane(qp.p_diag),
        *(lane(a) for a in state), iters=ST.check_every, alpha=ST.alpha,
        sigma=ST.sigma, interpret=True)
    xla = xla_round(qp, jnp.moveaxis(ci_l, -1, 0),
                    jnp.moveaxis(wp_l, -1, 0)[:, 1:], state, rk, re, bnd)
    got = fused_rounds.fused_admm_round(
        fused_rounds.collision_rows(t(qp.coll_coef)), t(ci_l), t(wp_l),
        t(lane(qp.t_prev)), *(t(lane(a)) for a in bnd), t(lane(rk)),
        t(lane(re)), t(qp.end_idx).to(torch.int32), t(lane(qp.p_diag)),
        *(t(lane(a)) for a in state), ST.check_every, ST.alpha, ST.sigma)
    for name, g, p, x in zip(("v", "zk", "ze", "yk", "ye", "res"), got,
                             pallas, xla):
        tk.assert_close(g, x, ROUND_TOL)
        assert departs(p, x, ROUND_TOL), name


def test_collision_rows_refuses_other_structures():
    """K2 takes rows with zero kappa and u columns and one unit slack each;
    collision_rows raises ValueError on anything else, on the CPU as on
    the GPU, before any round. The rough QP's rows differ by knot."""
    qp = rough_qps([0.5])
    cc = t(qp.coll_coef)
    rows = fused_rounds.collision_rows(cc)
    assert rows.shape == (16, 2, 2, 1) and rows.is_contiguous()
    assert not bool((rows == rows[:1]).all())
    np.testing.assert_array_equal(
        fused_rounds.coll_coef_from_rows(rows).numpy(), cc.numpy())
    for col, val in ((2, 0.5), (3, 1.0), (4, 2.0), (5, 1.0)):
        bad = cc.clone()
        bad[0, 3, 0, col] = val
        with pytest.raises(ValueError):
            fused_rounds.collision_rows(bad)
    with pytest.raises(ValueError):
        fused_rounds.collision_rows(cc[..., :5])


def test_port_rough_solve_matches_jax_xla_path():
    """The port on the CPU under rough_constraints_far_away against the JAX
    package's XLA path on the golden batch (the rough fixture, which
    tests/test_torch_fixtures.py regenerates): all 8 ok, flags equal, paths
    at golden.TOLERANCES; the rows beyond 30 m are the rough ones."""
    want = golden.load(golden.FIXTURES["rough"])
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    cfg = PlannerConfig(**golden.CONFIGS["rough"])
    res = pipeline.solve_batch(gm, scs, cfg, device="cpu")
    assert bool(res.ok.all())
    failures, diffs = golden.compare(golden.arrays(res), want)
    assert not failures, (failures, diffs)
    geo = pipeline.run_to_geometry(gm, scs, cfg, cfg.qp_settings())[0]
    qp = pipeline.build_path_qp(scs, geo, cfg)
    far = (geo[0].s >= cfg.precise_planning_length) & qp.knot_mask
    assert bool(far.any())
    np.testing.assert_array_equal(
        qp.coll_coef[far].numpy(),
        np.broadcast_to([[1, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1]],
                        (int(far.sum()), 2, 6)))


# ----------------------------------- pscan -----------------------------------

def test_solve_batched_pscan_matches_jax_and_float64():
    """The log-depth scan solve in float32 against the JAX package's
    associative-scan solve and the sequential solve, on float32 factors, at
    the rounds' ROUND_TOL; and in float64 against a dense float64 solve of
    the normal matrix (to_dense), to 1e-8 relative. At the path QP's
    blocks (nb 6), the only solve pscan selects."""
    diag, off = tk.normal_blocks64("path_nb6", 0.1)
    Ci64, W64 = btridiag.inv_factors(*btridiag.factor(diag, off))
    Ci, W = Ci64.float(), W64.float()
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.normal(size=Ci.shape[:3]).astype(np.float32))
    got = btridiag.solve_batched_pscan(Ci, W, b)
    assert got.dtype == torch.float32 and got.shape == b.shape
    want = jbtridiag.solve_batched_pscan(*(jnp.asarray(a.numpy())
                                           for a in (Ci, W, b)))
    tk.assert_close(got, want, ROUND_TOL)
    tk.assert_close(got, btridiag.solve_batched(Ci, W, b), ROUND_TOL)
    x64 = torch.linalg.solve(btridiag.to_dense(diag, off),
                             b.double().reshape(b.shape[0], -1, 1))
    tk.assert_close(btridiag.solve_batched_pscan(Ci64, W64, b.double()),
                    x64.reshape(b.shape).numpy(), dict(atol=1e-10,
                                                       rtol=1e-8))


def test_btridiag_solve_and_to_dense_match_jax():
    diag, off = tk.normal_blocks64("path_nb6", 0.1)
    C, W = btridiag.factor(diag, off)
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.normal(size=C.shape[:3]))
    with jax.enable_x64(True):
        for i in range(diag.shape[0]):
            np.testing.assert_allclose(
                btridiag.to_dense(diag, off)[i].numpy(),
                jbtridiag.to_dense(jnp.asarray(diag[i].numpy()),
                                   jnp.asarray(off[i].numpy())), atol=0)
            want = jbtridiag.solve(jnp.asarray(C[i].numpy()),
                                   jnp.asarray(W[i].numpy()),
                                   jnp.asarray(b[i].numpy()))
            np.testing.assert_allclose(btridiag.solve(C, W, b)[i].numpy(),
                                       want, atol=1e-9, rtol=1e-9)


def test_pscan_path_solve_equals_the_sequential_one():
    """QPSettings(fused_rounds=False, pscan=True) solves the rough chicane
    QPs as the sequential plain rounds do: the same flags, iterations
    within one check interval, v within the ADMM tolerance; on the kernels'
    path (fused_rounds=True) pscan changes nothing, as in the JAX
    package."""
    qp = convert.path_qp({f.name: np.asarray(getattr(q, f.name))
                          for q in [rough_qps([0.8, -0.5, 0.0, 0.3])]
                          for f in dataclasses.fields(q)}, "cpu")
    seq, par = (path_solver.solve_path_qp_batched(
        qp, settings=QPSettings(fused_rounds=False, pscan=p))
        for p in (False, True))
    assert bool(seq.converged.all())
    np.testing.assert_array_equal(par.converged.numpy(),
                                  seq.converged.numpy())
    assert int((par.iters - seq.iters).abs().max()) <= ST.check_every
    np.testing.assert_allclose(par.v.numpy(), seq.v.numpy(), atol=5e-3)
    fused = [path_solver.solve_path_qp_batched(
        qp, settings=QPSettings(pscan=p)) for p in (False, True)]
    np.testing.assert_array_equal(fused[0].v.numpy(), fused[1].v.numpy())


def test_jax_pscan_setting_matches_port_on_path_qps():
    """The JAX package's XLA rounds with pscan and the port's on the same
    rough QPs: flags equal, iterations within one interval, v at 5e-3."""
    from tpu_pathopt.qp.admm import QPSettings as JaxSettings
    from tpu_pathopt.solver import path_solver as jps
    qp_j = rough_qps([0.8, -0.5, 0.0, 0.3])
    want = jps.solve_path_qp_batched(
        qp_j, settings=JaxSettings(fused_rounds=False, pscan=True))
    qp = convert.path_qp({f.name: np.asarray(getattr(qp_j, f.name))
                          for f in dataclasses.fields(qp_j)}, "cpu")
    got = path_solver.solve_path_qp_batched(
        qp, settings=QPSettings(fused_rounds=False, pscan=True))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() \
        <= ST.check_every
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=5e-3)
