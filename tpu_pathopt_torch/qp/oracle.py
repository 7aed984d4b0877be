"""NumPy float64 reference implementation of the OSQP algorithm (the
oracle), the port's own copy of ``tpu_pathopt.qp.oracle``.

The reference consumes OSQP through osqp-eigen for all five QP solves per
query (SURVEY.md §2.7). This module re-implements the published OSQP
algorithm (Stellato et al., 2020, "OSQP: an operator splitting solver for
quadratic programs"):

- modified Ruiz equilibration with cost scaling (OSQP ``scaling=10`` default),
- ADMM with relaxation alpha=1.6, sigma=1e-6,
- per-constraint rho with a 1e3 boost on equality rows (l == u),
- adaptive rho (sqrt of residual ratio, refactor on >5x change),
- unscaled-residual termination with eps_abs/eps_rel (OSQP defaults 1e-3
  unless overridden; the reference path QP uses 2e-3, base_solver.cpp:61-62).

Solves are dense (numpy.linalg) and run on the host. The pipeline does not
use it: it is the yardstick the port's solvers are held to. The code is the
JAX package's, line for line, so both give the same bits on the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

OSQP_INFTY = 1e30


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    iters: int
    status: str
    pri_res: float
    dua_res: float
    # Per-check-point trajectory (solve(trace=True)): dict of stacked arrays
    # (x, z, y, rho_bar, pri_res, dua_res), one row per check_every iterations
    # — for iterate-by-iterate parity against qp.admm.trace_rounds.
    trace: dict | None = None


def ruiz_equilibration(P, q, A, iters=10):
    """Modified Ruiz scaling of [[P, A^T], [A, 0]] with cost scaling c.
    Returns (D, E, c) diagonals such that the scaled problem uses
    P' = c D P D, q' = c D q, A' = E A D, bounds' = E l, E u."""
    nv = P.shape[0]
    nc = A.shape[0]
    D = np.ones(nv)
    E = np.ones(nc)
    c = 1.0
    Pw = P.copy()
    Aw = A.copy()
    qw = q.copy()
    for _ in range(iters):
        # Column norms of the full KKT-ish matrix [P; A] per variable,
        # row norms of A per constraint.
        col_norm = np.maximum(
            np.abs(Pw).max(axis=0, initial=0.0),
            np.abs(Aw).max(axis=0, initial=0.0))
        row_norm = np.abs(Aw).max(axis=1, initial=0.0)
        d = 1.0 / np.sqrt(np.maximum(col_norm, 1e-12))
        e = 1.0 / np.sqrt(np.maximum(row_norm, 1e-12))
        d = np.clip(d, 1e-8, 1e8)
        e = np.clip(e, 1e-8, 1e8)
        Pw = d[:, None] * Pw * d[None, :]
        Aw = e[:, None] * Aw * d[None, :]
        qw = d * qw
        D *= d
        E *= e
        # Cost scaling.
        p_col_mean = np.abs(Pw).max(axis=0, initial=0.0).mean()
        g = 1.0 / max(max(p_col_mean, np.abs(qw).max(initial=0.0)), 1e-12)
        g = min(max(g, 1e-8), 1e8)
        Pw *= g
        qw *= g
        c *= g
    return D, E, c


def solve(P, q, A, l, u, eps_abs=2e-3, eps_rel=2e-3, max_iter=20000,
          sigma=1e-6, alpha=1.6, rho_bar=0.1, scaling_iters=10,
          adaptive_rho=True, check_every=25, x0=None, y0=None, trace=False):
    """Solve min 0.5 x^T P x + q^T x  s.t.  l <= A x <= u, OSQP-style."""
    P = np.asarray(P, np.float64)
    q = np.asarray(q, np.float64)
    A = np.asarray(A, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    nv = P.shape[0]
    nc = A.shape[0]

    if scaling_iters > 0:
        D, E, c = ruiz_equilibration(P, q, A, scaling_iters)
    else:
        D, E, c = np.ones(nv), np.ones(nc), 1.0
    Ps = c * D[:, None] * P * D[None, :]
    qs = c * D * q
    As = E[:, None] * A * D[None, :]
    ls = E * l
    us = E * u

    eq = (us - ls) < 1e-12
    loose = (ls < -OSQP_INFTY * 1e-10) & (us > OSQP_INFTY * 1e-10)

    def make_rho(rho_val):
        rho = np.full(nc, rho_val)
        rho[eq] = rho_val * 1e3
        rho[loose] = rho_val * 1e-6
        return rho

    rho = make_rho(rho_bar)

    def factor(rho):
        M = Ps + sigma * np.eye(nv) + As.T @ (rho[:, None] * As)
        return np.linalg.cholesky(M)

    L = factor(rho)

    x = np.zeros(nv) if x0 is None else (x0 / D)
    y = np.zeros(nc) if y0 is None else (y0 * E / c)
    z = As @ x

    status = "max_iter"
    iters = max_iter
    pri_res = dua_res = np.inf
    tr = {"x": [], "z": [], "y": [], "rho_bar": [], "pri_res": [],
          "dua_res": []} if trace else None
    for k in range(1, max_iter + 1):
        rhs = sigma * x - qs + As.T @ (rho * z - y)
        xt = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
        zt = As @ xt
        x_new = alpha * xt + (1 - alpha) * x
        z_tmp = alpha * zt + (1 - alpha) * z + y / rho
        z_new = np.clip(z_tmp, ls, us)
        y = rho * (z_tmp - z_new)
        x, z = x_new, z_new

        if k % check_every == 0 or k == max_iter:
            # Unscaled residuals (OSQP termination is on the original problem).
            x_u = D * x
            z_u = z / E
            y_u = c_inv_y = (1.0 / c) * (E * y)
            Ax = A @ x_u
            pri_res = np.abs(Ax - z_u).max(initial=0.0)
            dua = P @ x_u + q + A.T @ y_u
            dua_res = np.abs(dua).max(initial=0.0)
            eps_pri = eps_abs + eps_rel * max(np.abs(Ax).max(initial=0.0),
                                              np.abs(z_u).max(initial=0.0))
            eps_dua = eps_abs + eps_rel * max(
                np.abs(P @ x_u).max(initial=0.0),
                np.abs(A.T @ y_u).max(initial=0.0),
                np.abs(q).max(initial=0.0))
            if pri_res <= eps_pri and dua_res <= eps_dua:
                status = "solved"
                iters = k
                break
            if adaptive_rho:
                num = pri_res / max(np.abs(Ax).max(initial=0.0),
                                    np.abs(z_u).max(initial=0.0), 1e-12)
                den = dua_res / max(np.abs(P @ x_u).max(initial=0.0),
                                    np.abs(A.T @ y_u).max(initial=0.0),
                                    np.abs(q).max(initial=0.0), 1e-12)
                ratio = np.sqrt(num / max(den, 1e-12))
                if ratio > 5.0 or ratio < 0.2:
                    rho_bar = float(np.clip(rho_bar * ratio, 1e-6, 1e6))
                    rho = make_rho(rho_bar)
                    L = factor(rho)
            if trace:
                # Same observation point as qp.admm.trace_rounds: end of a
                # check_every round, after the adaptive-rho update.
                tr["x"].append(D * x)
                tr["z"].append(z / E)
                tr["y"].append((E * y) / c)
                tr["rho_bar"].append(rho_bar)
                tr["pri_res"].append(pri_res)
                tr["dua_res"].append(dua_res)

    return OracleResult(x=D * x, y=(E * y) / c, z=z / E, iters=iters,
                        status=status, pri_res=pri_res, dua_res=dua_res,
                        trace=({k: np.asarray(v) for k, v in tr.items()}
                               if trace else None))
