"""Structured ADMM solver for the lateral path QP, batched (port of
``tpu_pathopt.solver.path_solver``; reference: base_solver.cpp:56-117).

OSQP semantics: relaxed ADMM, per-row rho classes, per-element adaptive rho
with refactorization only where needed, unscaled-residual termination,
converged elements frozen, warm starts through ``v0``/``y0_*``/``rho0``.

With ``settings.fused_rounds`` (the default) the factorization runs through
kernel K1 and every ``check_every``-iteration round through kernel K2, whose
arrays are batch-last; the residuals come back from the kernel. Otherwise the
plain PyTorch rounds run. The rounds are batch-global: each round's loop
test and refactor gate are host reads.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.solver import assembly, fused_rounds
from tpu_pathopt_torch.solver.assembly import PathQP
from tpu_pathopt_torch.solver.fused_rounds import lane, unlane


@dataclasses.dataclass
class PathQPSolution:
    v: torch.Tensor          # (B, N, 6) per-knot [l, e_psi, kappa, u, s_f, s_r]
    y_knot: torch.Tensor     # (B, N, 6) duals in the z layout
    y_end: torch.Tensor      # (B, 2)
    iters: torch.Tensor      # (B,) int64
    converged: torch.Tensor  # (B,) bool
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    # Final per-element rho; pass 2 starts from pass 1's (OSQP keeps rho
    # across warm-started re-solves, base_solver.cpp:97-117).
    rho_bar: torch.Tensor    # (B,)
    rounds: int = 0          # batch-global rounds run (host-side loop)


def solve_path_qp_batched(qp: PathQP, v0=None, y0_knot=None, y0_end=None,
                          settings: QPSettings = QPSettings(),
                          rho0=None) -> PathQPSolution:
    """Solve a batch of path QPs on the device their tensors lie on."""
    st = settings
    if st.pscan:
        raise NotImplementedError("QPSettings.pscan is not ported yet")
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    fused = st.fused_rounds

    lb_knot, ub_knot, lb_end, ub_end = assembly.bounds(qp)
    cls_knot, cls_end = assembly.rho_classes(qp)
    end_idx = assembly.end_knot(qp.end_idx, N)
    ops = (qp.t_prev, qp.coll_coef, end_idx)

    def factor(rho_bar):
        rk = rho_bar[:, None, None] * cls_knot
        re = rho_bar[:, None] * cls_end
        diag, off = assembly.normal_blocks(qp, rk, re, st.sigma)
        if fused:
            offp = torch.cat([torch.zeros_like(diag[:, :1]), off], 1)
            Ci, W = fused_rounds.fused_factor(lane(diag), lane(offp))
            return lane(rk), lane(re), Ci, W
        C, W = btridiag.factor(diag, off)
        Cinv, W = btridiag.inv_factors(C, W)
        return rk, re, Cinv, W

    rho_bar = (torch.full((B,), st.rho_bar, dtype=dt, device=dev)
               if rho0 is None else
               torch.as_tensor(rho0, dtype=dt, device=dev).expand(B).clone())
    rk, re, Ci, W = factor(rho_bar)
    v = torch.zeros((B, N, assembly.NB), dtype=dt, device=dev) \
        if v0 is None else v0
    yk = torch.zeros((B, N, 6), dtype=dt, device=dev) \
        if y0_knot is None else y0_knot
    ye = torch.zeros((B, 2), dtype=dt, device=dev) \
        if y0_end is None else y0_end
    zk, ze = assembly.a_mul_blocks(*ops, v)
    state = (v, zk, ze, yk, ye)
    if fused:
        # Kernel layout for the whole solve: batch last.
        geom = (qp.coll_coef[0, 0, 0, 1].item(), qp.coll_coef[0, 0, 1, 1].item())
        end_i32 = end_idx.to(torch.int32).contiguous()
        tp_l = lane(qp.t_prev)
        lbk_l, ubk_l = lane(lb_knot), lane(ub_knot)
        lbe_l, ube_l = lane(lb_end), lane(ub_end)
        pd_l = lane(qp.p_diag)
        state = tuple(lane(a) for a in state)
        sel = lambda m, a: m.reshape((1,) * (a.dim() - 1) + (B,))  # noqa: E731
    else:
        sel = lambda m, a: m.reshape((B,) + (1,) * (a.dim() - 1))  # noqa: E731

    it = torch.zeros((B,), dtype=torch.long, device=dev)
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    pri = torch.full((B,), torch.inf, dtype=dt, device=dev)
    dua = torch.full((B,), torch.inf, dtype=dt, device=dev)
    rounds = 0

    while bool(torch.any(~conv & (it < st.max_iter))):
        rounds += 1
        if fused:
            *new, res = fused_rounds.fused_admm_round(
                geom, Ci, W, tp_l, lbk_l, ubk_l, lbe_l, ube_l, rk, re,
                end_i32, pd_l, *state, iters=st.check_every, alpha=st.alpha,
                sigma=st.sigma)
        else:
            new = state
            for _ in range(st.check_every):
                new = fused_rounds.path_admm_step(
                    ops, Ci, W, lb_knot, ub_knot, lb_end, ub_end, rk, re,
                    new, st.alpha, st.sigma)
            # Residuals of the unfrozen iterate, as the kernel returns them;
            # converged elements' values are discarded below.
            res = fused_rounds.path_residuals(ops, qp.p_diag, *new)
        state = tuple(torch.where(sel(conv, a), a, n)
                      for a, n in zip(state, new))
        it = torch.where(conv, it, it + st.check_every)

        pri_res, dua_res, n_az, n_pd = res[0], res[1], res[2], res[3]
        eps_pri = st.eps_abs + st.eps_rel * n_az
        eps_dua = st.eps_abs + st.eps_rel * n_pd
        conv_new = conv | ((pri_res <= eps_pri) & (dua_res <= eps_dua))

        if st.adaptive_rho:
            num = pri_res / torch.clamp(n_az, min=1e-12)
            den = dua_res / torch.clamp(n_pd, min=1e-12)
            ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
            need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
            rho_bar_new = torch.where(
                need, torch.clamp(rho_bar * ratio, 1e-6, 1e6), rho_bar)
            if bool(torch.any(need)):
                rk_n, re_n, Ci_n, W_n = factor(rho_bar_new)
                rk = torch.where(sel(need, rk), rk_n, rk)
                re = torch.where(sel(need, re), re_n, re)
                Ci = torch.where(sel(need, Ci), Ci_n, Ci)
                W = torch.where(sel(need, W), W_n, W)
            rho_bar = rho_bar_new

        pri = torch.where(conv, pri, pri_res)
        dua = torch.where(conv, dua, dua_res)
        conv = conv_new

    if fused:
        state = tuple(unlane(a) for a in state)
    v, _, _, yk, ye = state
    return PathQPSolution(v=v, y_knot=yk, y_end=ye, iters=it, converged=conv,
                          pri_res=pri, dua_res=dua, rho_bar=rho_bar,
                          rounds=rounds)
