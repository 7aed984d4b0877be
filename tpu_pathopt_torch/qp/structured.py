"""Generic block-banded structured ADMM engine, batched (port of
``tpu_pathopt.qp.structured``).

Problem form (every field batch-leading):

    min 0.5 v^T P v + q^T v   s.t.  lb <= A v <= ub
    P block-tridiagonal: p_diag[i] = P[i, i], p_off[i] = P[i, i-1]
    A block-banded:      row group i = a_cur[i] v_i + a_prev[i] v_{i-1}

Serves the TENSION2 (nb = 4, r = 3), post-smoothing (nb = 3, r = 3) and
TENSION (nb = 9, r = 9) QPs.
OSQP semantics: relaxed ADMM, per-row rho classes, per-element adaptive rho
with selective refactor, unscaled-residual termination; converged elements
stay frozen. The rounds run batch-global (``Segments.loop``): setup,
round and refactor are separate functions over one in-place state, and each
round computes its loop test and refactor gate on the device, so a compiled
call runs them as conditional nodes of one CUDA graph.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.qp.admm import INFTY, QPSettings
from tpu_pathopt_torch.solver import fused_rounds
from tpu_pathopt_torch.solver.fused_rounds import lane, unlane
from tpu_pathopt_torch.torchutil import EAGER, SOLVERS, compiled


@dataclasses.dataclass
class BlockBandedQP:
    p_diag: torch.Tensor    # (B, N, nb, nb) symmetric diagonal Hessian blocks
    p_off: torch.Tensor     # (B, N, nb, nb) sub-diagonal blocks, p_off[:, 0] = 0
    q: torch.Tensor         # (B, N, nb)
    a_cur: torch.Tensor     # (B, N, r, nb)
    a_prev: torch.Tensor    # (B, N, r, nb), a_prev[:, 0] = 0
    lb: torch.Tensor        # (B, N, r)
    ub: torch.Tensor        # (B, N, r)

    @property
    def nb(self) -> int:
        return self.a_cur.shape[-1]

    @property
    def r(self) -> int:
        return self.a_cur.shape[-2]


def _shift_down(x):
    """x[i-1] aligned to i (zero at 0) along axis 1."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def a_mul(qp: BlockBandedQP, v):
    """A @ v: (B, N, nb) -> (B, N, r)."""
    return (torch.einsum("bnrj,bnj->bnr", qp.a_cur, v)
            + torch.einsum("bnrj,bnj->bnr", qp.a_prev, _shift_down(v)))


def at_mul(qp: BlockBandedQP, w):
    """A^T @ w: (B, N, r) -> (B, N, nb)."""
    out = torch.einsum("bnrj,bnr->bnj", qp.a_cur, w)
    shifted = torch.einsum("bnrj,bnr->bnj", qp.a_prev, w)
    return out + torch.cat([shifted[:, 1:], torch.zeros_like(shifted[:, :1])],
                           dim=1)


def p_mul(qp: BlockBandedQP, v):
    """P @ v for the block-tridiagonal Hessian."""
    y = torch.einsum("bnij,bnj->bni", qp.p_diag, v)
    lo = torch.einsum("bnij,bnj->bni", qp.p_off, _shift_down(v))
    hi = torch.einsum("bnji,bnj->bni", qp.p_off[:, 1:], v[:, 1:])
    return y + lo + torch.cat([hi, torch.zeros_like(hi[:, :1])], dim=1)


def rho_classes(qp: BlockBandedQP):
    """Per-row rho multipliers: 1e3 on equality rows, 1e-6 on loose rows."""
    eq = (qp.ub - qp.lb) < 1e-9
    loose = (qp.lb < -0.5 * INFTY) & (qp.ub > 0.5 * INFTY)
    return torch.where(eq, 1e3, torch.where(loose, 1e-6, 1.0)).to(qp.lb.dtype)


def normal_blocks(qp: BlockBandedQP, rho, sigma):
    """Blocks of M = P + sigma I + A^T diag(rho) A. rho: (B, N, r). Returns
    (diag (B, N, nb, nb), offp (B, N, nb, nb) with offp[:, 0] = 0 and
    offp[:, i] = M[i, i-1])."""
    eye = torch.eye(qp.nb, dtype=qp.p_diag.dtype, device=qp.p_diag.device)
    diag = qp.p_diag + sigma * eye
    diag = diag + torch.einsum("bnri,bnr,bnrj->bnij", qp.a_cur, rho, qp.a_cur)
    ap_term = torch.einsum("bnri,bnr,bnrj->bnij", qp.a_prev, rho, qp.a_prev)
    diag = diag + torch.cat([ap_term[:, 1:], torch.zeros_like(ap_term[:, :1])],
                            dim=1)
    offp = qp.p_off + torch.einsum("bnri,bnr,bnrj->bnij", qp.a_cur, rho,
                                   qp.a_prev)
    return diag, offp


def to_dense(qp: BlockBandedQP):
    """The batch as dense (P, q, A, l, u): P (B, N nb, N nb), A (B, N r,
    N nb), variables knot-major and rows group-major, as the JAX package's
    ``to_dense`` orders them. For the dense solvers and the oracle."""
    B, N, r, nb = qp.a_cur.shape
    i = torch.arange(N, device=qp.q.device)
    A4 = qp.a_cur.new_zeros((B, N, N, r, nb))
    A4[:, i, i] = qp.a_cur
    A4[:, i[1:], i[:-1]] = qp.a_prev[:, 1:]
    A = A4.permute(0, 1, 3, 2, 4).reshape(B, N * r, N * nb)
    return (btridiag.to_dense(qp.p_diag, qp.p_off[:, 1:]),
            qp.q.reshape(B, -1), A, qp.lb.reshape(B, -1),
            qp.ub.reshape(B, -1))


@dataclasses.dataclass
class StructuredSolution:
    v: torch.Tensor          # (B, N, nb)
    y: torch.Tensor          # (B, N, r)
    z: torch.Tensor          # (B, N, r)
    iters: torch.Tensor      # (B,) int64
    converged: torch.Tensor  # (B,) bool
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    # Batch-global rounds run: an int on the eager path, a 0-d device
    # tensor in a compiled call (``Segments.loop``).
    rounds: int | torch.Tensor = 0


@dataclasses.dataclass
class StructuredRun:
    """One batch of block-banded solves in flight: the QP, its kernel-layout
    copies and row classes (read only), and the loop state, which the
    rounds and refactors update in place (``Segments.loop``). ``flags``
    is the round's loop test and refactor gate: any element still active,
    any element that needs a refactor."""
    qp: BlockBandedQP
    cls_rho: torch.Tensor
    lanes: tuple | None      # (a_cur, a_prev, q, lb, ub) batch-last
    rho: torch.Tensor
    Ci: torch.Tensor
    W: torch.Tensor
    v: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho_bar: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    need: torch.Tensor
    flags: torch.Tensor


def _factor(qp: BlockBandedQP, cls_rho, rho_bar, st: QPSettings):
    rho = rho_bar[:, None, None] * cls_rho
    diag, offp = normal_blocks(qp, rho, st.sigma)
    if st.fused_rounds:
        Ci_l, Wp_l = fused_rounds.fused_factor(lane(diag), lane(offp))
        return rho, Ci_l, Wp_l
    C, W = btridiag.factor(diag, offp[:, 1:])
    Cinv, W = btridiag.inv_factors(C, W)
    return rho, Cinv, W


def structured_setup(qp: BlockBandedQP, v0=None, y0=None,
                     settings: QPSettings = QPSettings()) -> StructuredRun:
    """The factorization (K1 with ``settings.fused_rounds``) and the loop
    state before the first round. Every state tensor is new, so the rounds
    may write into it (a given ``v0``/``y0`` is copied)."""
    st = settings
    B, N, nb = qp.q.shape
    r = qp.r
    dt, dev = qp.q.dtype, qp.q.device
    cls_rho = rho_classes(qp)
    lanes = (tuple(lane(a) for a in (qp.a_cur, qp.a_prev, qp.q, qp.lb,
                                     qp.ub))
             if st.fused_rounds else None)
    rho_bar = torch.full((B,), st.rho_bar, dtype=dt, device=dev)
    rho, Ci, W = _factor(qp, cls_rho, rho_bar, st)
    v = torch.zeros((B, N, nb), dtype=dt, device=dev) if v0 is None \
        else v0.clone()
    y = torch.zeros((B, N, r), dtype=dt, device=dev) if y0 is None \
        else y0.clone()
    return StructuredRun(
        qp=qp, cls_rho=cls_rho, lanes=lanes, rho=rho, Ci=Ci, W=W, v=v,
        z=a_mul(qp, v), y=y, rho_bar=rho_bar,
        it=torch.zeros((B,), dtype=torch.long, device=dev),
        conv=torch.zeros((B,), dtype=torch.bool, device=dev),
        pri=torch.full((B,), torch.inf, dtype=dt, device=dev),
        dua=torch.full((B,), torch.inf, dtype=dt, device=dev),
        need=torch.zeros((B,), dtype=torch.bool, device=dev),
        flags=torch.ones((2,), dtype=torch.bool, device=dev))


def structured_round(run: StructuredRun, settings: QPSettings
                     ) -> StructuredRun:
    """One round: ``check_every`` ADMM iterations (K3, or the plain steps),
    the residuals, termination and the adaptive-rho update; the refactor
    it asks for is :func:`structured_refactor`."""
    st = settings
    qp, conv = run.qp, run.conv
    if st.fused_rounds:
        ac_l, ap_l, q_l, lb_l, ub_l = run.lanes
        v_n, z_n, y_n = map(unlane, fused_rounds.fused_structured_round(
            run.Ci, run.W, ac_l, ap_l, q_l, lb_l, ub_l, lane(run.rho),
            lane(run.v), lane(run.z), lane(run.y), iters=st.check_every,
            alpha=st.alpha, sigma=st.sigma))
    else:
        state = (run.v, run.z, run.y)
        for _ in range(st.check_every):
            state = fused_rounds.structured_step(qp, run.Ci, run.W, run.rho,
                                                 state, st.alpha, st.sigma)
        v_n, z_n, y_n = state

    c3 = conv[:, None, None]
    v = torch.where(c3, run.v, v_n)
    z = torch.where(c3, run.z, z_n)
    y = torch.where(c3, run.y, y_n)
    it = torch.where(conv, run.it, run.it + st.check_every)

    amax = fused_rounds._amax
    Av = a_mul(qp, v)
    pv = p_mul(qp, v) + qp.q
    Aty = at_mul(qp, y)
    pri_res = amax(Av - z)
    dua_res = amax(pv + Aty)
    n_az = torch.maximum(amax(Av), amax(z))
    eps_pri = st.eps_abs + st.eps_rel * n_az
    eps_dua = st.eps_abs + st.eps_rel * torch.maximum(
        torch.maximum(amax(pv - qp.q), amax(Aty)), amax(qp.q))
    conv_new = conv | ((pri_res <= eps_pri) & (dua_res <= eps_dua))

    rho_bar, need = run.rho_bar, torch.zeros_like(conv)
    if st.adaptive_rho:
        num = pri_res / torch.clamp(n_az, min=1e-12)
        den = dua_res / torch.clamp(torch.maximum(
            amax(pv - qp.q), torch.maximum(amax(Aty), amax(qp.q))),
            min=1e-12)
        ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
        need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
        rho_bar = torch.where(
            need, torch.clamp(rho_bar * ratio, 1e-6, 1e6), rho_bar)
    flags = torch.stack([torch.any(~conv_new & (it < st.max_iter)),
                         torch.any(need)])
    return dataclasses.replace(
        run, v=v, z=z, y=y, it=it, conv=conv_new, rho_bar=rho_bar, need=need,
        pri=torch.where(conv, run.pri, pri_res),
        dua=torch.where(conv, run.dua, dua_res), flags=flags)


def structured_refactor(run: StructuredRun, settings: QPSettings
                        ) -> StructuredRun:
    """Refactor at the adapted rho (K1) and keep the new factors on the
    elements that asked for them."""
    need = run.need
    rho_n, Ci_n, W_n = _factor(run.qp, run.cls_rho, run.rho_bar, settings)
    fsel = (need[None, None, None, :] if settings.fused_rounds
            else need[:, None, None, None])
    return dataclasses.replace(
        run, rho=torch.where(need[:, None, None], rho_n, run.rho),
        Ci=torch.where(fsel, Ci_n, run.Ci), W=torch.where(fsel, W_n, run.W))


def structured_solution(run: StructuredRun, rounds
                        ) -> StructuredSolution:
    return StructuredSolution(v=run.v, y=run.y, z=run.z, iters=run.it,
                              converged=run.conv, pri_res=run.pri,
                              dua_res=run.dua, rounds=rounds)


def solve_structured(drv, name: str, run: StructuredRun,
                     settings: QPSettings) -> tuple:
    """The rounds of a set-up solve through the segment runner ``drv``:
    the JAX package's ``lax.while_loop`` on ``any(~converged & (iters <
    max_iter))`` with a ``lax.cond`` around the refactor. Every element
    starts unconverged at iteration 0, so the first round runs whenever
    ``max_iter`` > 0. Returns (run, rounds)."""
    return drv.loop(name, run, functools.partial(structured_round,
                                                 settings=settings),
                    functools.partial(structured_refactor, settings=settings),
                    settings.max_iter > 0)


def _program(drv, qp: BlockBandedQP, v0, y0, settings: QPSettings
             ) -> StructuredSolution:
    run = drv("setup", functools.partial(structured_setup,
                                         settings=settings), qp, v0, y0)
    run, rounds = solve_structured(drv, "qp", run, settings)
    return structured_solution(run, rounds)


def solve_structured_batched_eager(qp: BlockBandedQP, v0=None, y0=None,
                                   settings: QPSettings = QPSettings()
                                   ) -> StructuredSolution:
    """:func:`solve_structured_batched` issued from the host, one read a
    round (``rounds`` a Python int)."""
    return _program(EAGER, qp, v0, y0, settings)


def solve_structured_batched(qp: BlockBandedQP, v0=None, y0=None,
                             settings: QPSettings = QPSettings()
                             ) -> StructuredSolution:
    """Solve a batch of block-banded QPs on the device their tensors lie on.

    With ``settings.fused_rounds`` the factorization and every round go
    through the kernels K1 and K3 (their plain versions for CPU tensors);
    otherwise through the plain PyTorch rounds. Residuals, termination and
    the adaptive-rho logic run outside the kernel. A compiled call, as the
    JAX package jits it (``torchutil.compiled``: on CUDA one graph per
    static key, the rounds a WHILE node, the refactor an IF node in it);
    bit for bit :func:`solve_structured_batched_eager`, ``rounds`` a 0-d
    device tensor."""
    return compiled(SOLVERS, ("structured", settings), functools.partial(
        _program, settings=settings), (qp, v0, y0), qp.q.device)[0]
