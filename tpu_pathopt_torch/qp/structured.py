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
stay frozen. The rounds run batch-global; each round's loop test and
refactor gate are host reads.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.qp.admm import INFTY, QPSettings
from tpu_pathopt_torch.solver import fused_rounds
from tpu_pathopt_torch.solver.fused_rounds import lane, unlane


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
    rounds: int = 0          # batch-global rounds run (host-side loop)


def solve_structured_batched(qp: BlockBandedQP, v0=None, y0=None,
                             settings: QPSettings = QPSettings()
                             ) -> StructuredSolution:
    """Solve a batch of block-banded QPs on the device their tensors lie on.

    With ``settings.fused_rounds`` the factorization and every round go
    through the kernels K1 and K3 (their plain versions for CPU tensors);
    otherwise through the plain PyTorch rounds. Residuals, termination and
    the adaptive-rho logic run outside the kernel."""
    st = settings
    B, N, nb = qp.q.shape
    r = qp.r
    dt, dev = qp.q.dtype, qp.q.device
    fused = st.fused_rounds
    cls_rho = rho_classes(qp)
    if fused:
        ac_l, ap_l, q_l = lane(qp.a_cur), lane(qp.a_prev), lane(qp.q)
        lb_l, ub_l = lane(qp.lb), lane(qp.ub)

    def factor(rho_bar):
        rho = rho_bar[:, None, None] * cls_rho
        diag, offp = normal_blocks(qp, rho, st.sigma)
        if fused:
            Ci_l, Wp_l = fused_rounds.fused_factor(lane(diag), lane(offp))
            return rho, Ci_l, Wp_l
        C, W = btridiag.factor(diag, offp[:, 1:])
        Cinv, W = btridiag.inv_factors(C, W)
        return rho, Cinv, W

    rho_bar = torch.full((B,), st.rho_bar, dtype=dt, device=dev)
    rho, Ci, W = factor(rho_bar)
    v = torch.zeros((B, N, nb), dtype=dt, device=dev) if v0 is None else v0
    y = torch.zeros((B, N, r), dtype=dt, device=dev) if y0 is None else y0
    z = a_mul(qp, v)
    it = torch.zeros((B,), dtype=torch.long, device=dev)
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    pri = torch.full((B,), torch.inf, dtype=dt, device=dev)
    dua = torch.full((B,), torch.inf, dtype=dt, device=dev)
    amax = fused_rounds._amax
    rounds = 0

    while bool(torch.any(~conv & (it < st.max_iter))):
        rounds += 1
        if fused:
            v_n, z_n, y_n = map(unlane, fused_rounds.fused_structured_round(
                Ci, W, ac_l, ap_l, q_l, lb_l, ub_l, lane(rho), lane(v),
                lane(z), lane(y), iters=st.check_every, alpha=st.alpha,
                sigma=st.sigma))
        else:
            state = (v, z, y)
            for _ in range(st.check_every):
                state = fused_rounds.structured_step(qp, Ci, W, rho, state,
                                                     st.alpha, st.sigma)
            v_n, z_n, y_n = state

        c3 = conv[:, None, None]
        v = torch.where(c3, v, v_n)
        z = torch.where(c3, z, z_n)
        y = torch.where(c3, y, y_n)
        it = torch.where(conv, it, it + st.check_every)

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

        if st.adaptive_rho:
            num = pri_res / torch.clamp(n_az, min=1e-12)
            den = dua_res / torch.clamp(torch.maximum(
                amax(pv - qp.q), torch.maximum(amax(Aty), amax(qp.q))),
                min=1e-12)
            ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
            need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
            rho_bar_new = torch.where(
                need, torch.clamp(rho_bar * ratio, 1e-6, 1e6), rho_bar)
            if bool(torch.any(need)):
                rho_n, Ci_n, W_n = factor(rho_bar_new)
                fsel = (need[None, None, None, :] if fused
                        else need[:, None, None, None])
                rho = torch.where(need[:, None, None], rho_n, rho)
                Ci = torch.where(fsel, Ci_n, Ci)
                W = torch.where(fsel, W_n, W)
            rho_bar = rho_bar_new

        pri = torch.where(conv, pri, pri_res)
        dua = torch.where(conv, dua, dua_res)
        conv = conv_new

    return StructuredSolution(v=v, y=y, z=z, iters=it, converged=conv,
                              pri_res=pri, dua_res=dua, rounds=rounds)
