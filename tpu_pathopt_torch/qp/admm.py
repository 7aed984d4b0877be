"""Dense OSQP-semantics ADMM QP solver (port of ``tpu_pathopt.qp.admm``).

Solves  min 0.5 x^T P x + q^T x  s.t.  l <= A x <= u  as OSQP does (the
solver behind every QP in the reference, base_solver.cpp:80-88):

- modified Ruiz equilibration + cost scaling (fixed iteration count),
- relaxed ADMM (alpha=1.6, sigma=1e-6) on the reduced normal equations
  M = P + sigma I + A^T diag(rho) A, factored by dense Cholesky,
- per-constraint rho with a 1e3 boost on equality rows and 1e-6 on loose
  rows, and adaptive rho (refactor when the residual ratio drifts > 5x),
- OSQP termination on unscaled residuals (eps_abs/eps_rel), warm starting.

:func:`solve_qp` solves one QP (Cholesky and two triangular solves an
iteration); :func:`solve_qp_batched` a leading batch of them (one Cholesky
and an explicit triangular inverse per rho update, so an iteration is two
batched matvecs; converged lanes are frozen). :func:`trace_rounds` runs
:func:`solve_qp`'s round body and records each round. The dtype and device
follow the inputs (float32 or float64, CPU or CUDA); each round ends in a
host read, the loop test. No entry point of the pipeline uses the dense
solver: it is the yardstick the structured solvers are held to.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pathopt_torch.torchutil import highest_precision

INFTY = 1e20


@dataclasses.dataclass(frozen=True)
class QPSettings:
    eps_abs: float = 2e-3
    eps_rel: float = 2e-3
    max_iter: int = 4000
    sigma: float = 1e-6
    alpha: float = 1.6
    rho_bar: float = 0.1
    # Initial rho for the lateral path QP; pass 2 also inherits pass 1's
    # final adapted rho (the reference's persistent OSQP solver object,
    # base_solver.cpp:97-117).
    rho_bar_path: float = 0.1
    scaling_iters: int = 10
    check_every: int = 25
    adaptive_rho: bool = True
    # Parallel-prefix block-tridiagonal solves in the plain path-QP rounds
    # (btridiag.solve_batched_pscan); the kernels and the structured
    # solver do not read it.
    pscan: bool = False
    # Run each check_every-iteration ADMM round, and every factorization,
    # through the CUDA kernels of ``solver.fused_rounds``. False runs the
    # plain PyTorch rounds instead.
    fused_rounds: bool = True


@dataclasses.dataclass
class QPSolution:
    x: torch.Tensor          # (..., nv)
    y: torch.Tensor          # (..., nc)
    z: torch.Tensor          # (..., nc)
    iters: torch.Tensor      # (...) int64
    converged: torch.Tensor  # (...) bool
    pri_res: torch.Tensor
    dua_res: torch.Tensor


def _amax(v):
    return v.abs().amax(dim=-1)


def _ruiz(P, q, A, iters):
    """Modified Ruiz scaling of [[P, A^T], [A, 0]] with cost scaling, over
    any leading batch axes. Returns the scaled (P, q, A) and (D, E, c)."""
    nc = A.shape[-2]
    D = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    E = torch.ones(A.shape[:-2] + (nc,), dtype=P.dtype, device=P.device)
    c = torch.ones(P.shape[:-2], dtype=P.dtype, device=P.device)
    for _ in range(iters):
        col = torch.maximum(P.abs().amax(dim=-2), A.abs().amax(dim=-2))
        row = A.abs().amax(dim=-1)
        d = torch.clamp(1.0 / torch.sqrt(torch.clamp(col, min=1e-12)),
                        1e-8, 1e8)
        e = torch.clamp(1.0 / torch.sqrt(torch.clamp(row, min=1e-12)),
                        1e-8, 1e8)
        P = d[..., :, None] * P * d[..., None, :]
        A = e[..., :, None] * A * d[..., None, :]
        q = d * q
        D = D * d
        E = E * e
        p_mean = P.abs().amax(dim=-2).mean(dim=-1)
        g = 1.0 / torch.clamp(torch.maximum(p_mean, _amax(q)), min=1e-12)
        g = torch.clamp(g, 1e-8, 1e8)
        P, q, c = P * g[..., None, None], q * g[..., None], c * g
    return P, q, A, D, E, c


def _make_rho(rho_bar, eq, loose):
    """Per-row rho: rho_bar (...), eq/loose (..., nc)."""
    rb = rho_bar[..., None]
    rho = torch.where(eq, rb * 1e3, rb)
    return torch.where(loose, rb * 1e-6, rho)


def _normal(Ps, As, rho, sigma):
    nv = Ps.shape[-1]
    eye = torch.eye(nv, dtype=Ps.dtype, device=Ps.device)
    return Ps + sigma * eye + As.mT @ (rho[..., :, None] * As)


def _factor(Ps, As, rho, sigma):
    """Cholesky factor of M; NaN where M is not positive definite in its
    dtype (as XLA's cholesky gives), so that QP iterates to NaN and stays
    unconverged instead of stopping the batch."""
    L, info = torch.linalg.cholesky_ex(_normal(Ps, As, rho, sigma))
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _chol_solve(L, b):
    w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, w, upper=True)[..., 0]


def _scale_bounds(l, u, E):
    ls = E * torch.clamp(l, -INFTY, INFTY)
    us = E * torch.clamp(u, -INFTY, INFTY)
    eq = (u - l) < 1e-9
    loose = (l < -0.5 * INFTY) & (u > 0.5 * INFTY)
    return ls, us, eq, loose


def _residuals(P, q, A, x_u, z_u, y_u, st):
    """Unscaled residuals and the quantities termination and adaptive rho
    read, per QP (leading axes kept)."""
    Ax = (A @ x_u[..., None])[..., 0]
    Px = (P @ x_u[..., None])[..., 0]
    Aty = (A.mT @ y_u[..., None])[..., 0]
    pri_res = _amax(Ax - z_u)
    dua_res = _amax(Px + q + Aty)
    n_pri = torch.maximum(_amax(Ax), _amax(z_u))
    n_dua = torch.maximum(torch.maximum(_amax(Px), _amax(Aty)), _amax(q))
    ok = ((pri_res <= st.eps_abs + st.eps_rel * n_pri)
          & (dua_res <= st.eps_abs + st.eps_rel * n_dua))
    return pri_res, dua_res, n_pri, n_dua, ok


def _rho_update(pri_res, dua_res, n_pri, n_dua, conv_new, rho_bar):
    """Which QPs refactor and their new rho_bar (OSQP's sqrt ratio rule,
    clipped to [1e-6, 1e6])."""
    num = pri_res / torch.clamp(n_pri, min=1e-12)
    den = dua_res / torch.clamp(n_dua, min=1e-12)
    ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
    need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
    return need, torch.where(need, torch.clamp(rho_bar * ratio, 1e-6, 1e6),
                             rho_bar)


def _relaxed_step(st, xt, x, z, y, As, rho, ls, us):
    zt = (As @ xt[..., None])[..., 0]
    x_new = st.alpha * xt + (1 - st.alpha) * x
    z_tmp = st.alpha * zt + (1 - st.alpha) * z + y / rho
    z_new = torch.clamp(z_tmp, ls, us)
    return x_new, z_new, rho * (z_tmp - z_new)


def _rhs(st, x, z, y, qs, As, rho):
    return st.sigma * x - qs + (As.mT @ (rho * z - y)[..., None])[..., 0]


# ------------------------------- one QP --------------------------------------

def _setup_scalar(P, q, A, l, u, x0, y0, st):
    """Scale the problem and build the initial carry (shared by the solver
    and the iterate tracer, so both run the same code)."""
    dt, dev = P.dtype, P.device
    Ps, qs, As, D, E, c = _ruiz(P, q, A, st.scaling_iters)
    ls, us, eq, loose = _scale_bounds(l, u, E)
    rho_bar0 = torch.tensor(st.rho_bar, dtype=dt, device=dev)
    rho0 = _make_rho(rho_bar0, eq, loose)
    L0 = _factor(Ps, As, rho0, st.sigma)
    x = torch.zeros(P.shape[-1], dtype=dt, device=dev) if x0 is None \
        else x0 / D
    y = torch.zeros(A.shape[-2], dtype=dt, device=dev) if y0 is None \
        else y0 * E / c
    z = As @ x
    scaled = (Ps, qs, As, D, E, c, ls, us, eq, loose)
    inf = torch.tensor(torch.inf, dtype=dt, device=dev)
    init = (x, z, y, rho0, L0, rho_bar0,
            torch.tensor(0, dtype=torch.long, device=dev),
            torch.tensor(False, device=dev), inf, inf)
    return scaled, init


def _make_scalar_round(P, q, A, scaled, st):
    """One check_every-iteration ADMM round, the residual check and the
    adaptive-rho update (the loop body of :func:`solve_qp`)."""
    Ps, qs, As, D, E, c, ls, us, eq, loose = scaled

    def admm_round(carry):
        x, z, y, rho, L, rho_bar, it, conv, pri, dua = carry
        x_n, z_n, y_n = x, z, y
        for _ in range(st.check_every):
            xt = _chol_solve(L, _rhs(st, x_n, z_n, y_n, qs, As, rho))
            x_n, z_n, y_n = _relaxed_step(st, xt, x_n, z_n, y_n, As, rho,
                                          ls, us)
        # Freeze a converged problem.
        x = torch.where(conv, x, x_n)
        z = torch.where(conv, z, z_n)
        y = torch.where(conv, y, y_n)
        it = torch.where(conv, it, it + st.check_every)

        pri_res, dua_res, n_pri, n_dua, ok = _residuals(
            P, q, A, D * x, z / E, (E * y) / c, st)
        conv_new = conv | ok
        if st.adaptive_rho:
            need, rho_bar_new = _rho_update(pri_res, dua_res, n_pri, n_dua,
                                            conv_new, rho_bar)
            if bool(need):
                rho = _make_rho(rho_bar_new, eq, loose)
                L = _factor(Ps, As, rho, st.sigma)
            rho_bar = rho_bar_new
        return (x, z, y, rho, L, rho_bar, it, conv_new,
                torch.where(conv, pri, pri_res),
                torch.where(conv, dua, dua_res))

    return admm_round


def solve_qp(P, q, A, l, u, x0=None, y0=None,
             settings: QPSettings = QPSettings()) -> QPSolution:
    """Solve one QP: P (nv, nv), q (nv,), A (nc, nv), l and u (nc,), on
    their device and in their dtype; ``x0``/``y0`` warm-start it."""
    st = settings
    with highest_precision():
        scaled, carry = _setup_scalar(P, q, A, l, u, x0, y0, st)
        D, E, c = scaled[3], scaled[4], scaled[5]
        admm_round = _make_scalar_round(P, q, A, scaled, st)
        while bool(~carry[7] & (carry[6] < st.max_iter)):
            carry = admm_round(carry)
    x, z, y, _, _, _, it, conv, pri, dua = carry
    return QPSolution(x=D * x, y=(E * y) / c, z=z / E, iters=it,
                      converged=conv, pri_res=pri, dua_res=dua)


def trace_rounds(P, q, A, l, u, settings: QPSettings = QPSettings(),
                 n_rounds: int = 8, x0=None, y0=None) -> dict:
    """Run exactly ``n_rounds`` rounds of :func:`solve_qp` (the same round
    body) and return the unscaled trajectory: a dict of x, z, y, rho_bar,
    pri_res and dua_res, each with a leading ``n_rounds`` axis, observed
    where ``qp.oracle.solve(trace=True)`` observes it. Set eps_abs =
    eps_rel = 0 to keep convergence from freezing the iterates."""
    st = settings
    keys = ("x", "z", "y", "rho_bar", "pri_res", "dua_res")
    tr = {k: [] for k in keys}
    with highest_precision():
        scaled, carry = _setup_scalar(P, q, A, l, u, x0, y0, st)
        D, E, c = scaled[3], scaled[4], scaled[5]
        admm_round = _make_scalar_round(P, q, A, scaled, st)
        for _ in range(n_rounds):
            carry = admm_round(carry)
            x, z, y, _, _, rho_bar, _, _, pri, dua = carry
            for k, v in zip(keys, (D * x, z / E, (E * y) / c, rho_bar, pri,
                                   dua)):
                tr[k].append(v)
    return {k: torch.stack(v) for k, v in tr.items()}


# ----------------------------- a batch of QPs --------------------------------

def _factor_inv(Ps, As, rho, sigma):
    """Linv with M^{-1} b = Linv^T (Linv b): the Cholesky factor of M and
    its explicit triangular inverse."""
    L = _factor(Ps, As, rho, sigma)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def solve_qp_batched(P, q, A, l, u, x0=None, y0=None,
                     settings: QPSettings = QPSettings()) -> QPSolution:
    """Solve a batch of QPs, a leading batch axis on every input (P (B, nv,
    nv), A (B, nc, nv), ...), on their device and in their dtype.

    One Cholesky factor and its explicit inverse per rho update, so every
    ADMM iteration is two batched matvecs; a round refactors only the QPs
    whose rho changed, and only when one did. Converged QPs are frozen.
    Semantics match :func:`solve_qp`."""
    st = settings
    B, nv = P.shape[0], P.shape[-1]
    nc = A.shape[-2]
    dt, dev = P.dtype, P.device
    with highest_precision():
        Ps, qs, As, D, E, c = _ruiz(P, q, A, st.scaling_iters)
        ls, us, eq, loose = _scale_bounds(l, u, E)
        rho_bar = torch.full((B,), st.rho_bar, dtype=dt, device=dev)
        rho = _make_rho(rho_bar, eq, loose)
        Linv = _factor_inv(Ps, As, rho, st.sigma)
        x = torch.zeros((B, nv), dtype=dt, device=dev) if x0 is None \
            else x0 / D
        y = torch.zeros((B, nc), dtype=dt, device=dev) if y0 is None \
            else y0 * E / c[:, None]
        z = (As @ x[..., None])[..., 0]
        it = torch.zeros((B,), dtype=torch.long, device=dev)
        conv = torch.zeros((B,), dtype=torch.bool, device=dev)
        pri = torch.full((B,), torch.inf, dtype=dt, device=dev)
        dua = torch.full((B,), torch.inf, dtype=dt, device=dev)

        while bool(torch.any(~conv & (it < st.max_iter))):
            x_n, z_n, y_n = x, z, y
            for _ in range(st.check_every):
                w = Linv @ _rhs(st, x_n, z_n, y_n, qs, As, rho)[..., None]
                xt = (Linv.mT @ w)[..., 0]
                x_n, z_n, y_n = _relaxed_step(st, xt, x_n, z_n, y_n, As,
                                              rho, ls, us)
            cv = conv[:, None]
            x = torch.where(cv, x, x_n)
            z = torch.where(cv, z, z_n)
            y = torch.where(cv, y, y_n)
            it = torch.where(conv, it, it + st.check_every)

            pri_res, dua_res, n_pri, n_dua, ok = _residuals(
                P, q, A, D * x, z / E, (E * y) / c[:, None], st)
            conv_new = conv | ok
            if st.adaptive_rho:
                need, rho_bar = _rho_update(pri_res, dua_res, n_pri, n_dua,
                                            conv_new, rho_bar)
                idx = need.nonzero()[:, 0]
                if len(idx):
                    rho_i = _make_rho(rho_bar[idx], eq[idx], loose[idx])
                    rho[idx] = rho_i
                    Linv[idx] = _factor_inv(Ps[idx], As[idx], rho_i,
                                            st.sigma)
            pri = torch.where(conv, pri, pri_res)
            dua = torch.where(conv, dua, dua_res)
            conv = conv_new

    return QPSolution(x=D * x, y=(E * y) / c[:, None], z=z / E, iters=it,
                      converged=conv, pri_res=pri, dua_res=dua)
