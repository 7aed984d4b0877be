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
batched matvecs; converged lanes are frozen; a refactor factors every lane
and keeps the new factor where rho changed, as the JAX package does).
:func:`trace_rounds` runs :func:`solve_qp`'s round body and records each
round. The dtype and device follow the inputs (float32 or float64, CPU or
CUDA).

Each is a compiled call, as the JAX package jits them
(``torchutil.compiled``): on CUDA one graph per static key, the rounds a
WHILE node and the refactor an IF node in it (the trace's WHILE node
counts its rounds on the device), no host read inside a call.
``<name>_eager`` runs the same program from the host, one read a round.
No entry point of the pipeline uses the dense solver: it is the yardstick
the structured solvers are held to, and the single-scenario smoothers'
solver.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_pathopt_torch.torchutil import (EAGER, SOLVERS, compiled,
                                         highest_precision, scan_round)

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
    # Rounds run: an int on the eager path, a 0-d device tensor in a
    # compiled call (read only after it).
    rounds: int | torch.Tensor = 0


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


# ------------------------------- the loop state -----------------------------

@dataclasses.dataclass
class DenseRun:
    """One dense solve (or a batch) in flight: the problem and its scaled
    form (read only) and the loop state, which the rounds and refactors
    update in place. ``L`` is the Cholesky factor (one QP) or its explicit
    inverse (a batch); ``flags`` is the round's loop test and refactor
    gate: any QP still active, any QP whose rho changed."""
    problem: tuple           # (P, q, A), unscaled
    scaled: tuple            # (Ps, qs, As, D, E, c, ls, us, eq, loose)
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    L: torch.Tensor
    rho_bar: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    need: torch.Tensor
    flags: torch.Tensor


def _round(run: DenseRun, st: QPSettings, solve) -> DenseRun:
    """One check_every-iteration ADMM round, the residual check and the
    adaptive-rho update; the refactor it asks for is :func:`_refactor`.
    ``solve(L, rhs)`` applies the factor: one QP or a batch of them (the
    QP axes lead, the variables last)."""
    P, q, A = run.problem
    Ps, qs, As, D, E, c, ls, us, eq, loose = run.scaled
    conv = run.conv
    x_n, z_n, y_n = run.x, run.z, run.y
    for _ in range(st.check_every):
        xt = solve(run.L, _rhs(st, x_n, z_n, y_n, qs, As, run.rho))
        x_n, z_n, y_n = _relaxed_step(st, xt, x_n, z_n, y_n, As, run.rho,
                                      ls, us)
    # Freeze converged problems.
    cv = conv[..., None]
    x = torch.where(cv, run.x, x_n)
    z = torch.where(cv, run.z, z_n)
    y = torch.where(cv, run.y, y_n)
    it = torch.where(conv, run.it, run.it + st.check_every)

    pri_res, dua_res, n_pri, n_dua, ok = _residuals(
        P, q, A, D * x, z / E, (E * y) / c[..., None], st)
    conv_new = conv | ok
    need, rho_bar = torch.zeros_like(conv), run.rho_bar
    if st.adaptive_rho:
        need, rho_bar = _rho_update(pri_res, dua_res, n_pri, n_dua, conv_new,
                                    rho_bar)
    flags = torch.stack([torch.any(~conv_new & (it < st.max_iter)),
                         torch.any(need)])
    return dataclasses.replace(
        run, x=x, z=z, y=y, it=it, conv=conv_new, rho_bar=rho_bar, need=need,
        pri=torch.where(conv, run.pri, pri_res),
        dua=torch.where(conv, run.dua, dua_res), flags=flags)


def _refactor(run: DenseRun, st: QPSettings, factor) -> DenseRun:
    """Refactor at the adapted rho: ``factor`` over every QP, the new
    factor and rho kept where rho changed (the JAX package's ``lax.cond``
    body: no index of the QPs that need it, whose shape the data would
    decide)."""
    Ps, qs, As, D, E, c, ls, us, eq, loose = run.scaled
    need = run.need
    rho_new = _make_rho(run.rho_bar, eq, loose)
    return dataclasses.replace(
        run, rho=torch.where(need[..., None], rho_new, run.rho),
        L=torch.where(need[..., None, None],
                      factor(Ps, As, rho_new, st.sigma), run.L))


def _setup(P, q, A, l, u, x0, y0, st: QPSettings, factor) -> DenseRun:
    """Scale the problem (one QP or a batch) and build the state before
    the first round; every state tensor is new, so the rounds may write
    into it."""
    dt, dev = P.dtype, P.device
    lead = P.shape[:-2]
    Ps, qs, As, D, E, c = _ruiz(P, q, A, st.scaling_iters)
    ls, us, eq, loose = _scale_bounds(l, u, E)
    rho_bar = torch.full(lead, st.rho_bar, dtype=dt, device=dev)
    rho = _make_rho(rho_bar, eq, loose)
    L = factor(Ps, As, rho, st.sigma)
    x = torch.zeros(lead + P.shape[-1:], dtype=dt, device=dev) \
        if x0 is None else x0 / D
    y = torch.zeros(lead + A.shape[-2:-1], dtype=dt, device=dev) \
        if y0 is None else y0 * E / c[..., None]
    z = (As @ x[..., None])[..., 0]
    return DenseRun(
        problem=(P, q, A), scaled=(Ps, qs, As, D, E, c, ls, us, eq, loose),
        x=x, z=z, y=y, rho=rho, L=L, rho_bar=rho_bar,
        it=torch.zeros(lead, dtype=torch.long, device=dev),
        conv=torch.zeros(lead, dtype=torch.bool, device=dev),
        pri=torch.full(lead, torch.inf, dtype=dt, device=dev),
        dua=torch.full(lead, torch.inf, dtype=dt, device=dev),
        need=torch.zeros(lead, dtype=torch.bool, device=dev),
        flags=torch.ones((2,), dtype=torch.bool, device=dev))


def _unscaled(run: DenseRun, rounds) -> QPSolution:
    D, E, c = run.scaled[3:6]
    return QPSolution(x=D * run.x, y=(E * run.y) / c[..., None],
                      z=run.z / E, iters=run.it, converged=run.conv,
                      pri_res=run.pri, dua_res=run.dua, rounds=rounds)


def _solve(drv, P, q, A, l, u, x0, y0, settings: QPSettings, solve,
           factor) -> QPSolution:
    """The program of a dense solve: setup, then the rounds through
    ``drv.loop`` (the JAX package's ``lax.while_loop`` with a ``lax.cond``
    around the refactor)."""
    st = settings
    with highest_precision():
        run = drv("setup", functools.partial(_setup, st=st, factor=factor),
                  P, q, A, l, u, x0, y0)
        run, rounds = drv.loop(
            "qp", run, functools.partial(_round, st=st, solve=solve),
            functools.partial(_refactor, st=st, factor=factor),
            st.max_iter > 0)
        return drv("solution", _unscaled, run, rounds)


# ------------------------------- one QP --------------------------------------

def _scalar_program(drv, P, q, A, l, u, x0, y0, settings):
    return _solve(drv, P, q, A, l, u, x0, y0, settings, _chol_solve, _factor)


def solve_qp_eager(P, q, A, l, u, x0=None, y0=None,
                   settings: QPSettings = QPSettings()) -> QPSolution:
    """:func:`solve_qp` issued from the host, one read a round."""
    return _scalar_program(EAGER, P, q, A, l, u, x0, y0, settings)


def solve_qp(P, q, A, l, u, x0=None, y0=None,
             settings: QPSettings = QPSettings()) -> QPSolution:
    """Solve one QP: P (nv, nv), q (nv,), A (nc, nv), l and u (nc,), on
    their device and in their dtype; ``x0``/``y0`` warm-start it. A
    compiled call (see the module), bit for bit :func:`solve_qp_eager`."""
    return compiled(SOLVERS, ("solve_qp", settings), functools.partial(
        _scalar_program, settings=settings), (P, q, A, l, u, x0, y0),
        P.device)[0]


_TRACE_KEYS = ("x", "z", "y", "rho_bar", "pri_res", "dua_res")


def _trace_program(drv, P, q, A, l, u, x0, y0, settings, n_rounds):
    """Exactly ``n_rounds`` rounds of :func:`solve_qp`'s program (the
    JAX package's ``lax.scan``), each recorded into its row of buffers
    allocated before the first (``torchutil.scan_round``; a refactor
    changes nothing the trace records, so the row is written before
    it)."""
    st = settings
    with highest_precision():
        run = drv("setup", functools.partial(_setup, st=st, factor=_factor),
                  P, q, A, l, u, x0, y0)
        tr = drv("trace.alloc", lambda run: {
            k: torch.empty((n_rounds,) + v.shape, dtype=v.dtype,
                           device=v.device)
            for k, v in zip(_TRACE_KEYS, (run.x, run.z, run.y, run.rho_bar,
                                          run.pri, run.dua))}, run)
        drv.loop("qp", run, scan_round(
            functools.partial(_round, st=st, solve=_chol_solve),
            [tr[k] for k in _TRACE_KEYS], _observed, n_rounds),
            functools.partial(_refactor, st=st, factor=_factor),
            n_rounds > 0)
    return tr


def _observed(run: DenseRun) -> tuple:
    """What a trace records of a round (``_TRACE_KEYS``), unscaled, where
    ``qp.oracle.solve(trace=True)`` observes it."""
    sol = _unscaled(run, 0)
    return sol.x, sol.z, sol.y, run.rho_bar, run.pri, run.dua


def trace_rounds_eager(P, q, A, l, u, settings: QPSettings = QPSettings(),
                       n_rounds: int = 8, x0=None, y0=None) -> dict:
    """:func:`trace_rounds` issued from the host."""
    return _trace_program(EAGER, P, q, A, l, u, x0, y0, settings, n_rounds)


def trace_rounds(P, q, A, l, u, settings: QPSettings = QPSettings(),
                 n_rounds: int = 8, x0=None, y0=None) -> dict:
    """Run exactly ``n_rounds`` rounds of :func:`solve_qp` (the same round
    body) and return the unscaled trajectory: a dict of x, z, y, rho_bar,
    pri_res and dua_res, each with a leading ``n_rounds`` axis, observed
    where ``qp.oracle.solve(trace=True)`` observes it. Set eps_abs =
    eps_rel = 0 to keep convergence from freezing the iterates. A compiled
    call keyed by ``n_rounds`` too, bit for bit
    :func:`trace_rounds_eager`."""
    return compiled(SOLVERS, ("trace_rounds", settings, n_rounds),
                    functools.partial(_trace_program, settings=settings,
                                      n_rounds=n_rounds),
                    (P, q, A, l, u, x0, y0), P.device)[0]


# ----------------------------- a batch of QPs --------------------------------

def _factor_inv(Ps, As, rho, sigma):
    """Linv with M^{-1} b = Linv^T (Linv b): the Cholesky factor of M and
    its explicit triangular inverse."""
    L = _factor(Ps, As, rho, sigma)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def _inv_solve(Linv, b):
    w = Linv @ b[..., None]
    return (Linv.mT @ w)[..., 0]


def _batched_program(drv, P, q, A, l, u, x0, y0, settings):
    return _solve(drv, P, q, A, l, u, x0, y0, settings, _inv_solve,
                  _factor_inv)


def solve_qp_batched_eager(P, q, A, l, u, x0=None, y0=None,
                           settings: QPSettings = QPSettings()
                           ) -> QPSolution:
    """:func:`solve_qp_batched` issued from the host, one read a round."""
    return _batched_program(EAGER, P, q, A, l, u, x0, y0, settings)


def solve_qp_batched(P, q, A, l, u, x0=None, y0=None,
                     settings: QPSettings = QPSettings()) -> QPSolution:
    """Solve a batch of QPs, a leading batch axis on every input (P (B, nv,
    nv), A (B, nc, nv), ...), on their device and in their dtype.

    One Cholesky factor and its explicit inverse per rho update, so every
    ADMM iteration is two batched matvecs; a round that changes some QP's
    rho refactors (every QP, keeping the new factor where rho changed).
    Converged QPs are frozen. Semantics match :func:`solve_qp`. A compiled
    call (see the module), bit for bit :func:`solve_qp_batched_eager`."""
    return compiled(SOLVERS, ("solve_qp_batched", settings),
                    functools.partial(_batched_program, settings=settings),
                    (P, q, A, l, u, x0, y0), P.device)[0]
