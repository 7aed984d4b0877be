"""The port's dense OSQP solver (``qp/admm.py``) against the JAX package's
and the float64 oracle: the counterparts of ``tests/test_qp.py`` and
``tests/test_qp_kkt.py``.

Each case feeds the same seeded numpy QP to both packages. Tolerances:
- float64: x, y and z within 1e-9 of the JAX solver's and the same
  iteration count (the same algorithm; the two differ only in the order of
  float64 sums);
- float32: the same converged flags and, at the default tolerance,
  iterations within one residual-check interval (a count inside one
  interval flips on float reassociation, ``tests/test_replan.py``), and x
  within the JAX test's own band against the oracle: 2e-2, feasibility
  5e-3;
- ``solve_qp_batched`` against ``solve_qp`` at the JAX test's 5e-3;
- the KKT certificate of ``test_qp_kkt.py`` for the port's oracle copy and
  for the port's float64 ``solve_qp``, at its 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt.qp import admm as jadmm
from tpu_pathopt.qp import oracle as joracle
from tpu_pathopt_torch import convert
from tpu_pathopt_torch.qp import admm, oracle

from test_qp import _random_qp
from test_qp_kkt import X_TOL, _certify_kkt, _random_banded_qp

CHECK = admm.QPSettings().check_every
TIGHT = dict(eps_abs=1e-6, eps_rel=1e-6)


def t32(*arrays):
    return convert.dense_qp([np.float32(a) for a in arrays], "cpu")


def t64(*arrays):
    return convert.dense_qp([np.float64(a) for a in arrays], "cpu")


def jax64(fn, *arrays, **kw):
    """fn on float64 JAX arrays, the result as the port's QPSolution."""
    with jax.enable_x64(True):
        sol = fn(*(jnp.asarray(a, jnp.float64) for a in arrays), **kw)
        return convert.qp_solution({k: np.asarray(v) for k, v in
                                    vars(sol).items()}, "cpu")


def assert_same_float64(got, want):
    for name in ("x", "y", "z"):
        assert getattr(want, name).dtype == torch.float64
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)


def test_scalar_box_qp():
    # min (x-1)^2 s.t. 0 <= x <= 0.5  ->  x = 0.5
    args = ([[2.0]], [-2.0], [[1.0]], [0.0], [0.5])
    sol = admm.solve_qp(*t32(*args))
    want = jadmm.solve_qp(*(jnp.asarray(a, jnp.float32) for a in args))
    assert bool(sol.converged) and int(sol.iters) == int(want.iters)
    np.testing.assert_allclose(float(sol.x[0]), 0.5, atol=2e-3)


def test_equality_qp_matches_kkt():
    rng = np.random.default_rng(0)
    nv, nc = 20, 10
    F = rng.normal(size=(nv, nv))
    P = F @ F.T / nv + np.eye(nv)
    q = rng.normal(size=nv)
    A = rng.normal(size=(nc, nv))
    b = rng.normal(size=nc)
    K = np.block([[P, A.T], [A, np.zeros((nc, nc))]])
    sol_kkt = np.linalg.solve(K, np.concatenate([-q, b]))[:nv]
    sol = admm.solve_qp(*t32(P, q, A, b, b),
                        settings=admm.QPSettings(eps_abs=1e-5, eps_rel=1e-5))
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.x.numpy(), sol_kkt, atol=5e-3)


def test_random_qps_match_jax_in_float64():
    rng = np.random.default_rng(1)
    for _ in range(3):
        qp = _random_qp(rng)
        for st in (admm.QPSettings(**TIGHT), admm.QPSettings()):
            want = jax64(jadmm.solve_qp, *qp,
                         settings=jadmm.QPSettings(eps_abs=st.eps_abs,
                                                   eps_rel=st.eps_rel))
            assert_same_float64(admm.solve_qp(*t64(*qp), settings=st), want)


def test_random_qps_match_oracle_and_jax_in_float32():
    """At the default tolerance the converged flags are equal and the
    iterations within one interval. At 1e-4 both packages' float32
    residuals sit at float32's noise floor (2e-4 to 6e-4 on these QPs,
    where float64 reaches 1e-5), so the round that first dips below the
    threshold is round-off: there x is held to the oracle, as the JAX
    test holds its own."""
    rng = np.random.default_rng(1)
    st = admm.QPSettings(eps_abs=1e-4, eps_rel=1e-4)
    for trial in range(3):
        P, q, A, l, u = _random_qp(rng)
        sol = admm.solve_qp(*t32(P, q, A, l, u))
        want = jadmm.solve_qp(*(jnp.asarray(a, jnp.float32)
                                for a in (P, q, A, l, u)))
        assert bool(sol.converged) == bool(want.converged) is True, trial
        assert abs(int(sol.iters) - int(want.iters)) <= CHECK

        ref = oracle.solve(P, q, A, l, u, **TIGHT)
        assert ref.status == "solved"
        sol = admm.solve_qp(*t32(P, q, A, l, u), settings=st)
        assert bool(sol.converged), trial
        obj_ref = 0.5 * ref.x @ P @ ref.x + q @ ref.x
        x = sol.x.numpy().astype(np.float64)
        obj = 0.5 * x @ P @ x + q @ x
        assert obj <= obj_ref + 1e-2 * (1 + abs(obj_ref))
        np.testing.assert_allclose(x, ref.x, atol=2e-2)
        Ax = A @ x
        assert np.all(Ax >= l - 5e-3) and np.all(Ax <= u + 5e-3)


def test_warm_start_reduces_iterations():
    rng = np.random.default_rng(2)
    qp = t32(*_random_qp(rng))
    cold = admm.solve_qp(*qp)
    warm = admm.solve_qp(*qp, x0=cold.x, y0=cold.y)
    assert bool(warm.converged)
    assert int(warm.iters) <= int(cold.iters)
    assert int(warm.iters) < int(cold.iters)


def stack(probs, conv=t32):
    return conv(*(np.stack([p[i] for p in probs]) for i in range(5)))


def test_batch_matches_single():
    rng = np.random.default_rng(3)
    probs = [_random_qp(rng, nv=12, nc=16, n_eq=4) for _ in range(4)]
    batched = admm.solve_qp_batched(*stack(probs))
    assert bool(batched.converged.all())
    for i, p in enumerate(probs):
        single = admm.solve_qp(*t32(*p))
        np.testing.assert_allclose(batched.x[i].numpy(), single.x.numpy(),
                                   atol=5e-3)


def test_batched_solver_matches_scalar_oracle_and_jax():
    """solve_qp_batched agrees with the oracle (the JAX test's 5e-2 in
    float32) and, in float64, with the JAX package's solve_qp_batched to
    1e-9 with the same iterations."""
    rng = np.random.default_rng(7)
    probs = [_random_qp(rng) for _ in range(4)]
    sol = admm.solve_qp_batched(*stack(probs))
    assert bool(sol.converged.all())
    for i, p in enumerate(probs):
        ref = oracle.solve(*p)
        assert ref.status == "solved"
        np.testing.assert_allclose(sol.x[i].numpy(), ref.x, atol=5e-2,
                                   rtol=5e-2)
    arrays = [np.stack([p[i] for p in probs]) for i in range(5)]
    st = dict(eps_abs=1e-6, eps_rel=1e-6)
    want = jax64(jadmm.solve_qp_batched, *arrays,
                 settings=jadmm.QPSettings(**st))
    assert_same_float64(admm.solve_qp_batched(
        *t64(*arrays), settings=admm.QPSettings(**st)), want)


def test_batched_solver_warm_start():
    rng = np.random.default_rng(8)
    qp = stack([_random_qp(rng) for _ in range(3)])
    cold = admm.solve_qp_batched(*qp)
    warm = admm.solve_qp_batched(*qp, x0=cold.x, y0=cold.y)
    assert bool(warm.converged.all())
    assert bool((warm.iters <= cold.iters).all())


@pytest.mark.parametrize("seed,nv,nc,n_eq", [
    (0, 12, 10, 3),
    (1, 20, 24, 6),
    (2, 30, 28, 8),
    (3, 30, 40, 10),
    (4, 24, 24, 0),
])
def test_oracle_and_float64_solver_certified_by_exact_kkt(seed, nv, nc,
                                                          n_eq):
    """The port's oracle copy gives the JAX oracle's bits and the optimum
    that the exact KKT solve on its active set certifies; the port's
    float64 solve_qp reaches the same optimum."""
    rng = np.random.default_rng(seed)
    P, q, A, l, u = _random_banded_qp(rng, nv, nc, n_eq)
    kw = dict(eps_abs=1e-11, eps_rel=1e-11, max_iter=400000, check_every=25)
    res = oracle.solve(P, q, A, l, u, **kw)
    ref = joracle.solve(P, q, A, l, u, **kw)
    assert res.status == ref.status == "solved" and res.iters == ref.iters
    for name in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    x_exact, _ = _certify_kkt(P, q, A, l, u, res)
    scale = max(1.0, np.abs(x_exact).max())
    np.testing.assert_allclose(res.x, x_exact, atol=X_TOL * scale)
    # The oracle's 1e30 bounds are beyond the solvers' INFTY, where they
    # clip; the row stays loose.
    sol = admm.solve_qp(*t64(P, q, A, l, u), settings=admm.QPSettings(
        eps_abs=1e-10, eps_rel=1e-10, max_iter=400000))
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.x.numpy(), x_exact, atol=1e-7 * scale)


def test_oracle_equality_only_matches_direct_kkt():
    rng = np.random.default_rng(7)
    nv, nc = 15, 6
    B = rng.standard_normal((nv, nv))
    P = B @ B.T / nv + np.eye(nv)
    q = rng.standard_normal(nv)
    A = rng.standard_normal((nc, nv))
    b = rng.standard_normal(nc) * 0.3
    res = oracle.solve(P, q, A, b, b, eps_abs=1e-11, eps_rel=1e-11,
                       max_iter=400000)
    assert res.status == "solved"
    KKT = np.block([[P, A.T], [A, np.zeros((nc, nc))]])
    sol = np.linalg.solve(KKT, np.concatenate([-q, b]))
    np.testing.assert_allclose(res.x, sol[:nv], atol=1e-8)
    np.testing.assert_allclose(res.y, sol[nv:], atol=1e-6)
    dense = admm.solve_qp(*t64(P, q, A, b, b), settings=admm.QPSettings(
        eps_abs=1e-10, eps_rel=1e-10, max_iter=400000))
    np.testing.assert_allclose(dense.x.numpy(), sol[:nv], atol=1e-7)
