"""The port's float64 ``trace_rounds`` held iterate by iterate against the
NumPy oracle: the counterpart of ``tests/test_admm_trace.py``, with its
cases and tolerances.

Both sides run with termination off (eps = 0) in float64 and are observed
at the end of every check_every round. With fixed rho only float64
round-off separates them: x, z, y and the residuals within rtol 1e-7,
atol 1e-9. With adaptive rho a refactor can amplify library-level
round-off, so the refactor decisions must be the same, rho_bar within
5e-3 and x within 2e-2 over the live prefix (see the JAX test). The port's
copy of the oracle gives the JAX package's oracle's bits.
"""

import numpy as np
import pytest
import torch

from tpu_pathopt.qp import oracle as joracle
from tpu_pathopt_torch.qp import admm, oracle

from test_admm_trace import CHECK, ROUNDS, _random_qp


def _trace_both(P, q, A, l, u, settings):
    tr = admm.trace_rounds(*(torch.tensor(a, dtype=torch.float64)
                             for a in (P, q, A, l, u)),
                           settings=settings, n_rounds=ROUNDS)
    tr = {k: v.numpy() for k, v in tr.items()}
    ref = oracle.solve(P, q, A, l, u, eps_abs=0.0, eps_rel=0.0,
                       max_iter=ROUNDS * CHECK, check_every=CHECK,
                       rho_bar=settings.rho_bar,
                       adaptive_rho=settings.adaptive_rho, trace=True)
    assert ref.trace["x"].shape[0] == ROUNDS
    return tr, ref.trace


def _compare_fixed_rho(P, q, A, l, u, rho_bar=0.1):
    st = admm.QPSettings(eps_abs=0.0, eps_rel=0.0, adaptive_rho=False,
                         rho_bar=rho_bar)
    tr, ot = _trace_both(P, q, A, l, u, st)
    for key in ("x", "z", "y", "pri_res", "dua_res"):
        np.testing.assert_allclose(tr[key], ot[key], rtol=1e-7, atol=1e-9,
                                   err_msg=f"iterate {key} diverged")


def _compare_adaptive(P, q, A, l, u, rho_bar=0.1):
    st = admm.QPSettings(eps_abs=0.0, eps_rel=0.0, rho_bar=rho_bar)
    tr, ot = _trace_both(P, q, A, l, u, st)
    # Past the float64 noise floor the residual ratio is noise: compare
    # the live prefix only.
    live = (ot["pri_res"] > 1e-8) & (ot["dua_res"] > 1e-10)
    k = int(np.argmin(live)) if not live.all() else len(live)
    k = max(k, 2)
    np.testing.assert_allclose(tr["rho_bar"][:k], ot["rho_bar"][:k],
                               rtol=5e-3,
                               err_msg="adaptive-rho trajectories diverged")
    changed = lambda r: np.abs(np.diff(np.log(r[:k]))) > 1e-12  # noqa: E731
    np.testing.assert_array_equal(changed(tr["rho_bar"]),
                                  changed(ot["rho_bar"]))
    scale = max(np.abs(ot["x"]).max(), 1.0)
    np.testing.assert_allclose(tr["x"][:k], ot["x"][:k], rtol=2e-2,
                               atol=2e-2 * scale, err_msg="x diverged")


CASES = {
    "fixed_mixed": (0, {}, False, 0.1),
    "fixed_equality_only": (1, dict(kinds=("eq",)), False, 0.1),
    "fixed_all_loose": (2, dict(kinds=("loose",)), False, 0.1),
    "adaptive_mixed": (0, {}, True, 0.1),
    "adaptive_equality_only": (1, dict(kinds=("eq",)), True, 0.1),
    "rho_clip_1e-6": (3, {}, True, 1e-6),
    "rho_clip_1e6": (3, {}, True, 1e6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_parity_with_the_oracle(case):
    seed, kw, adaptive, rho_bar = CASES[case]
    qp = _random_qp(np.random.default_rng(seed), **kw)
    (_compare_adaptive if adaptive else _compare_fixed_rho)(*qp,
                                                            rho_bar=rho_bar)


def test_trace_matches_solver_fixed_point():
    """The traced trajectory converges to what solve_qp returns (the same
    round body)."""
    qp = tuple(torch.tensor(a, dtype=torch.float64)
               for a in _random_qp(np.random.default_rng(4)))
    st = admm.QPSettings(eps_abs=1e-6, eps_rel=1e-6)
    sol = admm.solve_qp(*qp, settings=st)
    tr = admm.trace_rounds(*qp, settings=st, n_rounds=40)
    assert bool(sol.converged)
    np.testing.assert_allclose(tr["x"][-1].numpy(), sol.x.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_copy_equals_the_jax_oracle_bit_for_bit(case):
    seed, kw, adaptive, rho_bar = CASES[case]
    qp = _random_qp(np.random.default_rng(seed), **kw)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, rho_bar=rho_bar,
              adaptive_rho=adaptive, trace=True)
    got, want = oracle.solve(*qp, **kw), joracle.solve(*qp, **kw)
    assert (got.status, got.iters) == (want.status, want.iters)
    for name in ("x", "y", "z", "pri_res", "dua_res"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name, v in want.trace.items():
        np.testing.assert_array_equal(got.trace[name], v, err_msg=name)
    np.testing.assert_array_equal(
        oracle.ruiz_equilibration(*qp[:3])[0],
        joracle.ruiz_equilibration(*qp[:3])[0])
