"""Structured assembly of the lateral path QP, batched (port of
``tpu_pathopt.solver.assembly``; reference: base_solver.cpp:119-261).

Variables per knot ``v_i = [l, e_psi, kappa, u, s_front, s_rear]``; rows per
knot in the "z" layout ``[trans(3), kappa(1), coll(2)]`` plus 2 end rows on
the last valid knot. Every field of :class:`PathQP` carries a leading batch
axis. Padded knots (index >= n_valid) get their transition rows turned into
x_i = 0 pins and their collision rows into slack pins with zero bounds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.geometry import constrain_angle
from tpu_pathopt_torch.qp.admm import INFTY
from tpu_pathopt_torch.torchutil import const

NB = 6  # variables per knot

# [-I3 | 0]: the transition rows' coefficients on their own knot.
T_CUR = np.concatenate([-np.eye(3, dtype=np.float32),
                        np.zeros((3, 3), np.float32)], axis=1)  # (3, 6)


@dataclasses.dataclass
class PathQP:
    """Structured lateral path QPs over N (padded) knots, batch-leading."""

    p_diag: torch.Tensor        # (B, N, 6) cost diagonal
    t_prev: torch.Tensor        # (B, N, 3, 6) transition block on knot i-1
    trans_rhs: torch.Tensor     # (B, N, 3)
    coll_coef: torch.Tensor     # (B, N, 2, 6) [front; rear]
    coll_lb: torch.Tensor       # (B, N, 2)
    coll_ub: torch.Tensor
    kappa_lb: torch.Tensor      # (B, N)
    kappa_ub: torch.Tensor
    end_idx: torch.Tensor       # (B,) int64, the knot of the end rows
    end_lb: torch.Tensor        # (B, 2) [l, e_psi]
    end_ub: torch.Tensor
    n_valid: torch.Tensor       # (B,) int64
    knot_mask: torch.Tensor     # (B, N) bool

    @property
    def n(self) -> int:
        return self.p_diag.shape[1]


def soft_bounds(lb, ub, safety_margin, min_clearance=0.1):
    """Shrink a corridor by up to `safety_margin` per side keeping at least
    `min_clearance` of width (getSoftBounds, base_solver.cpp:290-296)."""
    clearance = ub - lb
    remain = torch.clamp(clearance - 2.0 * safety_margin, min=min_clearance)
    shrink = torch.clamp((clearance - remain) / 2.0, min=0.0)
    return lb + shrink, ub - shrink


def assemble_path_qp(ref_s, ref_k, ref_heading_last, input_l, input_e,
                     input_k, front_lb, front_ub, rear_lb, rear_ub,
                     init_offset, init_heading_error, start_k,
                     target_heading, blocked, n_valid,
                     config: PlannerConfig, center_lb=None,
                     center_ub=None) -> PathQP:
    """Build the batch of structured QPs. Per-knot inputs are (B, N),
    per-scenario inputs (B,). input_* are the linearization path (pass 1:
    l = e = 0, k = k_ref; pass 2: the pass-1 solution)."""
    B, N = ref_s.shape
    dt = ref_s.dtype
    dev = ref_s.device
    idx = torch.arange(N, device=dev)
    n_valid = n_valid.long()
    knot_mask = idx < n_valid[:, None]

    p_diag = const(
        [config.weight_l, 0.0, config.weight_kappa, config.weight_dkappa,
         config.weight_slack, config.weight_slack],
        dtype=dt, device=dev).expand(B, N, NB)

    # --- Transition linearization (base_solver.cpp:160-187) ---
    ds = torch.diff(ref_s, dim=-1)
    ds = torch.where(ds > 1e-6, ds, 1.0)
    lbar, ebar, kbar = input_l[:, :-1], input_e[:, :-1], input_k[:, :-1]
    cos_e = torch.cos(ebar)
    tan_e = torch.tan(ebar)
    one_kl = 1.0 - kbar * lbar
    z = torch.zeros_like(lbar)
    df_x = torch.stack([
        torch.stack([-kbar * tan_e, one_kl / cos_e ** 2, z], dim=-1),
        torch.stack([-kbar ** 2 / cos_e, one_kl * kbar * tan_e / cos_e,
                     one_kl / cos_e], dim=-1),
        torch.stack([z, z, z], dim=-1),
    ], dim=-2)                                             # (B, N-1, 3, 3)
    A = torch.eye(3, dtype=dt, device=dev) + ds[..., None, None] * df_x
    B_ = ds[..., None] * const([0.0, 0.0, 1.0], dtype=dt, device=dev)
    u_input = (input_k[:, 1:] - input_k[:, :-1]) / ds
    f = torch.stack([one_kl * tan_e, one_kl * kbar / cos_e - ref_k[:, :-1],
                     u_input], dim=-1)                     # (B, N-1, 3)
    xbar = torch.stack([lbar, ebar, kbar], dim=-1)
    c = ds[..., None] * (f - torch.einsum("bnij,bnj->bni", df_x, xbar)
                         - B_ * u_input[..., None])

    t_prev_body = torch.cat(
        [A, B_[..., None], torch.zeros(B, N - 1, 3, 2, dtype=dt, device=dev)],
        dim=-1)                                            # (B, N-1, 3, 6)
    t_prev = torch.cat(
        [torch.zeros(B, 1, 3, NB, dtype=dt, device=dev), t_prev_body], dim=1)
    coupled = (idx >= 1) & (idx < n_valid[:, None])
    t_prev = torch.where(coupled[..., None, None], t_prev, 0.0)

    x0 = torch.stack([init_offset.to(dt), init_heading_error.to(dt),
                      start_k.to(dt)], dim=-1)             # (B, 3)
    trans_rhs_body = torch.cat([-x0[:, None, :], -c], dim=1)
    trans_rhs = torch.where((coupled | (idx == 0))[..., None],
                            trans_rhs_body, 0.0)

    # --- Curvature rows (base_solver.cpp:226-231) ---
    kl = config.kappa_limit
    kappa_lb = torch.full((B, N), -kl, dtype=dt, device=dev)
    kappa_ub = torch.full((B, N), kl, dtype=dt, device=dev)

    # --- Collision rows (base_solver.cpp:193-206, 232-248) ---
    coll = const([[1.0, config.front_length, 0.0, 0.0, 1.0, 0.0],
                  [1.0, config.rear_length, 0.0, 0.0, 0.0, 1.0]],
                 dtype=dt, device=dev)
    coll_coef = coll.expand(B, N, 2, NB)
    f_lb, f_ub = soft_bounds(front_lb, front_ub, config.expected_safety_margin)
    r_lb, r_ub = soft_bounds(rear_lb, rear_ub, config.expected_safety_margin)
    coll_lb = torch.stack([f_lb, r_lb], dim=-1)
    coll_ub = torch.stack([f_ub, r_ub], dim=-1)
    if config.rough_constraints_far_away:
        # Beyond precise_planning_length the reference keeps one
        # center-corridor row per knot with one slack (base_solver.cpp:25-37).
        # In the fixed 2-row layout row 0 becomes that row (l + s_front in
        # the center soft bounds) and row 1 pins the unused rear slack to 0.
        if center_lb is None or center_ub is None:
            raise ValueError("rough_constraints_far_away needs center bounds "
                             "(update_bounds(..., with_center=True))")
        rough = (ref_s >= config.precise_planning_length) & knot_mask
        rough_coef = const([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                            [0.0, 0.0, 0.0, 0.0, 0.0, 1.0]],
                           dtype=dt, device=dev)
        coll_coef = torch.where(rough[..., None, None], rough_coef, coll_coef)
        c_lb, c_ub = soft_bounds(center_lb, center_ub,
                                 config.expected_safety_margin)
        zero = torch.zeros_like(c_lb)
        coll_lb = torch.where(rough[..., None],
                              torch.stack([c_lb, zero], dim=-1), coll_lb)
        coll_ub = torch.where(rough[..., None],
                              torch.stack([c_ub, zero], dim=-1), coll_ub)
    coll_lb = torch.where(knot_mask[..., None], coll_lb, 0.0)
    coll_ub = torch.where(knot_mask[..., None], coll_ub, 0.0)

    # --- End rows (base_solver.cpp:249-260) ---
    end_idx = n_valid - 1
    end_psi = constrain_angle(target_heading.to(dt) - ref_heading_last.to(dt))
    use_heading = (bool(config.constraint_end_heading) & ~blocked.bool()
                   & (end_psi < 70.0 * math.pi / 180.0))
    end_lb = torch.stack([torch.full_like(end_psi, -1.0),
                          torch.where(use_heading, end_psi - 0.087, -INFTY)],
                         dim=-1)
    end_ub = torch.stack([torch.full_like(end_psi, 1.0),
                          torch.where(use_heading, end_psi + 0.087, INFTY)],
                         dim=-1)

    return PathQP(p_diag=p_diag, t_prev=t_prev, trans_rhs=trans_rhs,
                  coll_coef=coll_coef, coll_lb=coll_lb, coll_ub=coll_ub,
                  kappa_lb=kappa_lb, kappa_ub=kappa_ub, end_idx=end_idx,
                  end_lb=end_lb, end_ub=end_ub, n_valid=n_valid,
                  knot_mask=knot_mask)


# ---------------------------------------------------------------------------
# Structured constraint operators in the z layout. The end rows sit on knot
# clamp(end_idx, 0, N-1) so a device index is never out of range.
# ---------------------------------------------------------------------------

def end_knot(end_idx, n: int):
    return end_idx.long().clamp(0, n - 1)


def a_mul_blocks(t_prev, coll_coef, end_idx, v):
    """A @ v from the blocks. v: (B, N, 6) -> (z_knot (B, N, 6), z_end (B, 2))."""
    v_prev = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
    trans = -v[..., :3] + torch.einsum("bnij,bnj->bni", t_prev, v_prev)
    coll = torch.einsum("bnij,bnj->bni", coll_coef, v)
    z_knot = torch.cat([trans, v[..., 2:3], coll], dim=-1)
    e = end_knot(end_idx, v.shape[1])
    z_end = v[torch.arange(v.shape[0], device=v.device), e, :2]
    return z_knot, z_end


def at_mul_blocks(t_prev, coll_coef, end_idx, w_knot, w_end):
    """A^T @ w. w_knot: (B, N, 6), w_end: (B, 2) -> (B, N, 6)."""
    wt = w_knot[..., :3]
    zeros = torch.zeros_like(wt)
    out = torch.cat([-wt, zeros], dim=-1)
    contrib = torch.einsum("bnij,bni->bnj", t_prev[:, 1:], wt[:, 1:])
    out = out + torch.cat([contrib, torch.zeros_like(out[:, :1])], dim=1)
    out[..., 2] += w_knot[..., 3]
    out = out + torch.einsum("bnij,bni->bnj", coll_coef, w_knot[..., 4:6])
    e = end_knot(end_idx, w_knot.shape[1])
    b = torch.arange(w_knot.shape[0], device=w_knot.device)
    out[b, e, 0] += w_end[:, 0]
    out[b, e, 1] += w_end[:, 1]
    return out


def a_mul(qp: PathQP, v):
    return a_mul_blocks(qp.t_prev, qp.coll_coef, qp.end_idx, v)


def at_mul(qp: PathQP, w_knot, w_end):
    return at_mul_blocks(qp.t_prev, qp.coll_coef, qp.end_idx, w_knot, w_end)


def bounds(qp: PathQP):
    """(lb_knot (B,N,6), ub_knot, lb_end (B,2), ub_end) in the z layout."""
    lb_knot = torch.cat([qp.trans_rhs, qp.kappa_lb[..., None], qp.coll_lb], -1)
    ub_knot = torch.cat([qp.trans_rhs, qp.kappa_ub[..., None], qp.coll_ub], -1)
    return lb_knot, ub_knot, qp.end_lb, qp.end_ub


def rho_classes(qp: PathQP):
    """Per-row rho multipliers: 1e3 on equality (transition and pinned)
    rows, 1e-6 on loose rows, 1 elsewhere. Returns (knot (B,N,6), end (B,2))."""
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    knot = torch.cat([
        torch.full((B, N, 3), 1e3, dtype=dt, device=dev),
        torch.ones((B, N, 1), dtype=dt, device=dev),
        torch.where((qp.coll_ub - qp.coll_lb) < 1e-9, 1e3, 1.0).to(dt),
    ], dim=-1)
    end_loose = (qp.end_lb < -0.5 * INFTY) & (qp.end_ub > 0.5 * INFTY)
    end = torch.where(end_loose, 1e-6, 1.0).to(dt)
    return knot, end


def normal_blocks(qp: PathQP, rho_knot, rho_end, sigma):
    """Block-tridiagonal blocks of M = P + sigma I + A^T diag(rho) A.
    Returns (diag (B, N, 6, 6), off (B, N-1, 6, 6)) with off[i] = M[i+1, i]."""
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    tc = const(T_CUR.tolist(), dtype=dt, device=dev)
    rho_t = rho_knot[..., :3]
    diag = torch.diag_embed(qp.p_diag + sigma)
    diag = diag + torch.einsum("ij,bni,ik->bnjk", tc, rho_t, tc)
    tp = qp.t_prev[:, 1:]
    tp_term = torch.einsum("bnij,bni,bnik->bnjk", tp, rho_t[:, 1:], tp)
    diag = diag + torch.cat([tp_term, torch.zeros_like(diag[:, :1])], dim=1)
    diag[..., 2, 2] += rho_knot[..., 3]
    diag = diag + torch.einsum("bnij,bni,bnik->bnjk", qp.coll_coef,
                               rho_knot[..., 4:6], qp.coll_coef)
    e = end_knot(qp.end_idx, N)
    b = torch.arange(B, device=dev)
    diag[b, e, 0, 0] += rho_end[:, 0]
    diag[b, e, 1, 1] += rho_end[:, 1]
    off = torch.einsum("ij,bni,bnik->bnjk", tc, rho_t[:, 1:], tp)
    return diag, off


def to_dense(qp: PathQP):
    """The batch as dense (P, q, A, l, u): P (B, 6N, 6N), A (B, 6N + 2,
    6N), variables knot-major, rows the N x 6 knot rows in the z layout
    and then the two end rows, as the JAX package's ``to_dense`` orders
    them. For the dense solvers and the oracle."""
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    i = torch.arange(N, device=dev)
    cur = qp.coll_coef.new_zeros((B, N, 6, NB))
    cur[:, :, :3] = const(T_CUR.tolist(), dtype=dt, device=dev)
    cur[:, :, 3, 2] = 1.0
    cur[:, :, 4:] = qp.coll_coef
    A4 = qp.coll_coef.new_zeros((B, N, N, 6, NB))
    A4[:, i, i] = cur
    A4[:, i[1:], i[:-1], :3] = qp.t_prev[:, 1:]
    A_end = qp.coll_coef.new_zeros((B, 2, N * NB))
    b = torch.arange(B, device=dev)
    e = end_knot(qp.end_idx, N) * NB
    A_end[b, 0, e] = 1.0
    A_end[b, 1, e + 1] = 1.0
    A = torch.cat([A4.permute(0, 1, 3, 2, 4).reshape(B, N * 6, N * NB),
                   A_end], dim=1)
    lb_knot, ub_knot, lb_end, ub_end = bounds(qp)
    return (torch.diag_embed(qp.p_diag.reshape(B, -1)),
            qp.p_diag.new_zeros((B, N * NB)), A,
            torch.cat([lb_knot.reshape(B, -1), lb_end], dim=1),
            torch.cat([ub_knot.reshape(B, -1), ub_end], dim=1))
