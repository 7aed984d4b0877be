"""The OSQP algorithm in float64 NumPy and SciPy: the plain reference's QP
solver.

The published algorithm (Stellato et al., 2020, "OSQP: an operator
splitting solver for quadratic programs"), as the planner's reference
consumes it through osqp-eigen: modified Ruiz equilibration with cost
scaling (10 passes), ADMM with relaxation alpha 1.6 and sigma 1e-6, a
per-constraint rho with a 1e3 boost on equality rows and 1e-6 on free rows,
adaptive rho (the square root of the residual ratio, refactored on a change
beyond 5x), and termination on the unscaled residuals with eps_abs and
eps_rel, checked every ``check_every`` iterations.

The planner's QPs are banded (a knot couples only to its neighbours), so the
KKT system is kept sparse and factored by SuperLU: the same iterates as a
dense Cholesky, to rounding, at a cost linear in the horizon.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as splinalg

OSQP_INFTY = 1e30


@dataclasses.dataclass
class Result:
    x: np.ndarray
    y: np.ndarray
    iters: int
    status: str


def _col_absmax(M) -> np.ndarray:
    return np.asarray(abs(M).max(axis=0).todense()).ravel()


def _row_absmax(M) -> np.ndarray:
    return np.asarray(abs(M).max(axis=1).todense()).ravel()


def ruiz(P, q, A, iters=10):
    """(D, E, c): the diagonal scalings and the cost scale of the modified
    Ruiz equilibration of [[P, A^T], [A, 0]]."""
    D = np.ones(P.shape[0])
    E = np.ones(A.shape[0])
    c = 1.0
    Pw, Aw, qw = P.copy(), A.copy(), q.copy()
    for _ in range(iters):
        col = np.maximum(_col_absmax(Pw), _col_absmax(Aw))
        d = np.clip(1.0 / np.sqrt(np.maximum(col, 1e-12)), 1e-8, 1e8)
        e = np.clip(1.0 / np.sqrt(np.maximum(_row_absmax(Aw), 1e-12)),
                    1e-8, 1e8)
        Pw = sparse.diags(d) @ Pw @ sparse.diags(d)
        Aw = sparse.diags(e) @ Aw @ sparse.diags(d)
        qw = d * qw
        D *= d
        E *= e
        p_mean = _col_absmax(Pw).mean()
        g = 1.0 / max(max(p_mean, np.abs(qw).max(initial=0.0)), 1e-12)
        g = min(max(g, 1e-8), 1e8)
        Pw = Pw * g
        qw = qw * g
        c *= g
    return D, E, c


def solve(P, q, A, l, u, eps_abs=2e-3, eps_rel=2e-3, max_iter=4000,
          check_every=25, sigma=1e-6, alpha=1.6, rho_bar=0.1, x0=None,
          y0=None) -> Result:
    """min 0.5 x'Px + q'x subject to l <= Ax <= u."""
    P = sparse.csc_matrix(np.asarray(P, np.float64))
    A = sparse.csc_matrix(np.asarray(A, np.float64))
    q = np.asarray(q, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    nv, nc = P.shape[0], A.shape[0]

    D, E, c = ruiz(P, q, A)
    Ps = (c * (sparse.diags(D) @ P @ sparse.diags(D))).tocsc()
    qs = c * D * q
    As = (sparse.diags(E) @ A @ sparse.diags(D)).tocsc()
    AsT = As.T.tocsc()
    ls, us = E * l, E * u
    eq = (us - ls) < 1e-12
    loose = (ls < -OSQP_INFTY * 1e-10) & (us > OSQP_INFTY * 1e-10)

    def make_rho(val):
        rho = np.full(nc, val)
        rho[eq] = val * 1e3
        rho[loose] = val * 1e-6
        return rho

    def factor(rho):
        M = Ps + sigma * sparse.identity(nv) + AsT @ sparse.diags(rho) @ As
        return splinalg.splu(M.tocsc()).solve

    rho = make_rho(rho_bar)
    kkt = factor(rho)
    x = np.zeros(nv) if x0 is None else x0 / D
    y = np.zeros(nc) if y0 is None else y0 * E / c
    z = As @ x
    status, iters = "max_iter", max_iter
    Pu, Au, AuT = P, A, A.T.tocsc()
    for k in range(1, max_iter + 1):
        xt = kkt(sigma * x - qs + AsT @ (rho * z - y))
        zt = As @ xt
        x_new = alpha * xt + (1 - alpha) * x
        z_tmp = alpha * zt + (1 - alpha) * z + y / rho
        z_new = np.clip(z_tmp, ls, us)
        y = rho * (z_tmp - z_new)
        x, z = x_new, z_new
        if k % check_every and k != max_iter:
            continue
        x_u, z_u, y_u = D * x, z / E, (E * y) / c
        Ax = Au @ x_u
        Px = Pu @ x_u
        Aty = AuT @ y_u
        pri = np.abs(Ax - z_u).max(initial=0.0)
        dua = np.abs(Px + q + Aty).max(initial=0.0)
        pri_scale = max(np.abs(Ax).max(initial=0.0),
                        np.abs(z_u).max(initial=0.0))
        dua_scale = max(np.abs(Px).max(initial=0.0),
                        np.abs(Aty).max(initial=0.0),
                        np.abs(q).max(initial=0.0))
        if (pri <= eps_abs + eps_rel * pri_scale
                and dua <= eps_abs + eps_rel * dua_scale):
            status, iters = "solved", k
            break
        ratio = np.sqrt((pri / max(pri_scale, 1e-12))
                        / max(dua / max(dua_scale, 1e-12), 1e-12))
        if ratio > 5.0 or ratio < 0.2:
            rho_bar = float(np.clip(rho_bar * ratio, 1e-6, 1e6))
            rho = make_rho(rho_bar)
            kkt = factor(rho)
    return Result(x=D * x, y=(E * y) / c, iters=iters, status=status)
