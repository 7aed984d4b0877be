"""The port's QP layer against the JAX package's: path-QP assembly and its
structured operators, the batched path-QP solver (cold and warm started, as
the pipeline's two passes run it) and the block-banded solver of the
smoothing QPs.

Both packages run their CPU rounds here: the JAX package its XLA rounds,
the port its plain rounds, through the kernel wrappers (``fused_rounds``,
the default) and without them. Solved QPs must agree on the ``converged``
flags exactly, on the iteration count within one residual-check interval
(a count inside one interval flips on float reassociation, as
``tests/test_replan.py`` explains) and on the solution to the solvers'
2e-3 termination tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt.smoothing.post_smooth import build_post_structured as jpost
from tpu_pathopt.smoothing.tension2 import build_tension2_structured as jt2
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import path_solver as jpath_solver
from tpu_pathopt_torch import convert
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import structured
from tpu_pathopt_torch.qp.admm import INFTY, QPSettings
from tpu_pathopt_torch.smoothing.post_smooth import build_post_structured
from tpu_pathopt_torch.smoothing.tension2 import build_tension2_structured
from tpu_pathopt_torch.solver import assembly, path_solver

N = 24
CHECK = QPSettings().check_every


def t(a):
    return convert.tensor(np.array(a), "cpu")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def path_inputs():
    """Four path-QP input sets at N = 24: a chicane, a curve, a pinched
    blocked corridor and a short horizon (n_valid 17)."""
    rng = np.random.default_rng(0)
    s = np.arange(N, dtype=np.float32) * 0.3
    rows = []
    for b, (shift, kref, width, nv, blocked) in enumerate(
            [(0.8, 0.0, 1.2, N, False), (-0.4, 0.05, 1.5, N, False),
             (0.3, -0.02, 0.4, 20, True), (0.0, 0.01, 2.0, 17, False)]):
        c = np.where((s > 2.0) & (s < 5.0), shift, 0.0)
        k = kref * np.ones(N) + rng.normal(scale=0.005, size=N)
        rows.append(dict(
            ref_s=s, ref_k=k, ref_heading_last=0.1 * b,
            input_l=np.zeros(N), input_e=np.zeros(N), input_k=k,
            front_lb=c - width, front_ub=c + width,
            rear_lb=c - width - 0.1, rear_ub=c + width + 0.1,
            init_offset=0.2 * (b - 1), init_heading_error=0.05 * b,
            start_k=0.01 * b, target_heading=-0.05 * b, blocked=blocked,
            n_valid=nv))
    return {k: np.stack([np.asarray(r[k]) for r in rows]).astype(
        np.int32 if k == "n_valid" else bool if k == "blocked"
        else np.float32) for k in rows[0]}


@pytest.fixture(scope="module")
def path_qps():
    inp = path_inputs()
    jcfg, cfg = JaxConfig(n_knots=N), PlannerConfig(n_knots=N)
    qp_j = jax.vmap(lambda d: jassembly.assemble_path_qp(
        **d, config=jcfg))(inp)
    qp = assembly.assemble_path_qp(**{k: t(v) for k, v in inp.items()},
                                   config=cfg)
    return qp_j, qp


def test_assemble_path_qp_matches_jax(path_qps):
    qp_j, qp = path_qps
    want, got = fields(qp_j), fields(qp)
    assert set(got) == set(want)
    for name in want:
        if want[name].dtype.kind in "biu":
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(assembly.T_CUR, jassembly.T_CUR)
    assert float(qp.coll_ub.max()) <= INFTY


def test_path_operators_match_jax(path_qps):
    qp_j, qp = path_qps
    rng = np.random.default_rng(1)
    v = rng.normal(size=(4, N, 6)).astype(np.float32)
    wk = rng.normal(size=(4, N, 6)).astype(np.float32)
    we = rng.normal(size=(4, 2)).astype(np.float32)
    for g, w in zip(assembly.a_mul(qp, t(v)), jax.vmap(jassembly.a_mul)(
            qp_j, v)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        assembly.at_mul(qp, t(wk), t(we)).numpy(),
        jax.vmap(jassembly.at_mul)(qp_j, wk, we), atol=1e-5, rtol=1e-5)
    for g, w in zip(assembly.bounds(qp), jax.vmap(jassembly.bounds)(qp_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(assembly.rho_classes(qp),
                    jax.vmap(jassembly.rho_classes)(qp_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rk = rng.uniform(0.1, 2.0, (4, N, 6)).astype(np.float32)
    re = rng.uniform(0.1, 2.0, (4, 2)).astype(np.float32)
    got = assembly.normal_blocks(qp, t(rk), t(re), 1e-6)
    want = jax.vmap(jassembly.normal_blocks, in_axes=(0, 0, 0, None))(
        qp_j, rk, re, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-5)


def assert_solutions_agree(got, want, v_tol):
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    di = np.abs(got.iters.numpy() - np.asarray(want.iters))
    assert di.max() <= CHECK, (got.iters.tolist(), want.iters.tolist())
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=v_tol)


@pytest.mark.parametrize("fused", [True, False])
def test_solve_path_qp_batched_matches_jax_both_passes(path_qps, fused):
    """Pass 1 cold from the configured rho, pass 2 warm from pass 1's
    (v, y, rho), as the pipeline runs them."""
    qp_j, qp = path_qps
    st_j = JaxSettings()
    st = QPSettings(fused_rounds=fused)
    rho0 = st.rho_bar_path
    s1_j = jpath_solver.solve_path_qp_batched(
        qp_j, settings=st_j, rho0=jnp.full((4,), rho0))
    s1 = path_solver.solve_path_qp_batched(
        qp, settings=st, rho0=torch.full((4,), rho0))
    assert_solutions_agree(s1, s1_j, 2e-3)
    assert s1.rounds == int(s1.iters.max()) // CHECK

    # Pass 2 from the JAX package's pass-1 state in both packages.
    v0, yk, ye = (np.asarray(a) for a in (s1_j.v, s1_j.y_knot, s1_j.y_end))
    rho = np.asarray(s1_j.rho_bar)
    s2_j = jpath_solver.solve_path_qp_batched(
        qp_j, v0=v0, y0_knot=yk, y0_end=ye, settings=st_j, rho0=rho)
    s2 = path_solver.solve_path_qp_batched(
        qp, v0=t(v0), y0_knot=t(yk), y0_end=t(ye), settings=st, rho0=t(rho))
    assert_solutions_agree(s2, s2_j, 2e-3)
    np.testing.assert_allclose(s2.rho_bar.numpy(), np.asarray(s2_j.rho_bar),
                               rtol=1e-3)


def smoothing_inputs():
    rng = np.random.default_rng(2)
    M, L = 24, 14
    tq = dict(x=[], y=[], ang=[], k=[], s=[], nv=[])
    for nv in (18, 24):
        u = np.linspace(0, 1, M)
        x = 25.0 * u + rng.normal(scale=0.1, size=M)
        y = 2.0 * np.sin(3 * u) + rng.normal(scale=0.1, size=M)
        dx, dy = np.gradient(x), np.gradient(y)
        ang = np.arctan2(dy, dx)
        s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x),
                                                      np.diff(y)))])
        for key, val in zip(tq, (x, y, ang, np.gradient(ang), s, nv)):
            tq[key].append(val)
    tq = {k: np.asarray(v, np.int32 if k == "nv" else np.float32)
          for k, v in tq.items()}
    pq = dict(
        layers_s=np.tile(np.arange(L, dtype=np.float32) * 2.0, (2, 1)),
        lower=rng.uniform(-2.5, -0.5, (2, L)).astype(np.float32),
        upper=rng.uniform(0.5, 2.5, (2, L)).astype(np.float32),
        vehicle_l=np.asarray([0.3, -0.6], np.float32),
        n_layers=np.asarray([L, 10], np.int32))
    return tq, pq


@pytest.mark.parametrize("fused", [True, False])
def test_solve_structured_batched_matches_jax(fused):
    tq, pq = smoothing_inputs()
    jcfg, cfg = JaxConfig(), PlannerConfig()
    qps = [
        (jax.vmap(lambda *a: jt2(*a, jcfg))(*tq.values()),
         build_tension2_structured(*(t(v) for v in tq.values()), cfg)),
        (jax.vmap(lambda *a: jpost(*a, jcfg))(*pq.values()),
         build_post_structured(*(t(v) for v in pq.values()), cfg)),
    ]
    for qp_j, qp in qps:
        want, got = fields(qp_j), fields(qp)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        sol_j = jstructured.solve_structured_batched(qp_j,
                                                     settings=JaxSettings())
        sol = structured.solve_structured_batched(
            qp, settings=QPSettings(fused_rounds=fused))
        np.testing.assert_array_equal(sol.converged.numpy(),
                                      np.asarray(sol_j.converged))
        assert bool(sol.converged.all())
        di = np.abs(sol.iters.numpy() - np.asarray(sol_j.iters))
        assert di.max() <= CHECK
        np.testing.assert_allclose(sol.v.numpy(), np.asarray(sol_j.v),
                                   atol=5e-3)


def test_structured_operators_match_jax():
    tq, _ = smoothing_inputs()
    qp_j = jax.vmap(lambda *a: jt2(*a, JaxConfig()))(*tq.values())
    qp = convert.block_banded_qp(fields(qp_j), "cpu")
    rng = np.random.default_rng(3)
    v = rng.normal(size=qp.q.shape).astype(np.float32)
    w = rng.normal(size=qp.lb.shape).astype(np.float32)
    for fn, arg in (("a_mul", v), ("at_mul", w), ("p_mul", v)):
        np.testing.assert_allclose(
            getattr(structured, fn)(qp, t(arg)).numpy(),
            jax.vmap(getattr(jstructured, fn))(qp_j, arg), atol=1e-4,
            rtol=1e-5, err_msg=fn)
    np.testing.assert_array_equal(structured.rho_classes(qp).numpy(),
                                  jax.vmap(jstructured.rho_classes)(qp_j))
    rho = rng.uniform(0.1, 2.0, qp.lb.shape).astype(np.float32)
    for g, wnt in zip(structured.normal_blocks(qp, t(rho), 1e-6),
                      jax.vmap(jstructured.normal_blocks,
                               in_axes=(0, 0, None))(qp_j, rho, 1e-6)):
        np.testing.assert_allclose(g.numpy(), wnt, atol=1e-4, rtol=1e-5)


def test_pscan_is_not_ported_yet(path_qps):
    """QPSettings.pscan, once a raise, now selects the parallel-prefix solve
    of the plain rounds: the path QPs solve as with the sequential sweeps
    and as the JAX package's pscan rounds do (flags equal, iterations
    within one interval, v at the rounds' 5e-3)."""
    qp_j, qp = path_qps
    st = QPSettings(fused_rounds=False, pscan=True)
    got = path_solver.solve_path_qp_batched(qp, settings=st)
    seq = path_solver.solve_path_qp_batched(
        qp, settings=dataclasses.replace(st, pscan=False))
    want = jpath_solver.solve_path_qp_batched(
        qp_j, settings=JaxSettings(fused_rounds=False, pscan=True))
    assert_solutions_agree(got, want, 5e-3)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  seq.converged.numpy())
    np.testing.assert_allclose(got.v.numpy(), seq.v.numpy(), atol=5e-3)
