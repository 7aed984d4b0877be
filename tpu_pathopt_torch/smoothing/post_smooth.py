"""Post-smoothing QP over the DP corridor in block-banded form, batched
(port of ``tpu_pathopt.smoothing.post_smooth``; reference: postSmooth,
reference_path_smoother.cpp:526-636).

Variables per layer [l, l', l''] (nb = 3); rows per layer (r = 3): the
corridor range plus the two integration chains l_{i+1} - l_i = ds l'_i and
l'_{i+1} - l'_i = ds l''_i attached to their later endpoint; l_0 pinned to
the vehicle's lateral offset. The reference requires >= 4 layers, which the
caller reports through ``ok``. The dense form is not ported.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured


def build_post_structured(layers_s, lower, upper, vehicle_l, n_layers,
                          config: PlannerConfig) -> structured.BlockBandedQP:
    """layers_s/lower/upper (B, L), vehicle_l/n_layers (B,)."""
    B, L = layers_s.shape
    dt, dev = layers_s.dtype, layers_s.device
    idx = torch.arange(L, device=dev)
    nl = n_layers.long()[:, None]
    is_pad = (idx >= nl).to(dt)

    full = lambda w: torch.full((B, L), w, dtype=dt, device=dev)  # noqa: E731
    p_diag = torch.diag_embed(torch.stack([
        full(config.post_weight_l), full(config.post_weight_dl),
        full(config.post_weight_ddl) + is_pad], dim=-1))
    p_off = torch.zeros((B, L, 3, 3), dtype=dt, device=dev)
    q = torch.zeros((B, L, 3), dtype=dt, device=dev)

    ds = torch.diff(layers_s, dim=-1)
    seg_valid = idx[:L - 1] <= nl - 2
    ds = torch.where(seg_valid, torch.where(ds > 1e-6, ds, 1.0), 0.0)
    ds_g = torch.cat([ds[:, :1], ds], dim=1)
    valid_g = torch.cat([torch.zeros_like(seg_valid[:, :1]), seg_valid], 1)
    group0 = idx == 0

    zeros, ones = full(0.0), full(1.0)
    r0_cur = torch.stack([ones, zeros, zeros], -1)
    r1_cur = torch.where(valid_g[..., None],
                         torch.stack([ones, zeros, zeros], -1), 0.0)
    r1_prev = torch.where(valid_g[..., None],
                          torch.stack([-ones, -ds_g, zeros], -1),
                          torch.stack([zeros, ones, zeros], -1))
    r2_cur = torch.where(valid_g[..., None],
                         torch.stack([zeros, ones, zeros], -1), 0.0)
    r2_prev = torch.where(valid_g[..., None],
                          torch.stack([zeros, -ones, -ds_g], -1),
                          torch.stack([zeros, zeros, ones], -1))
    a_cur = torch.stack([r0_cur, r1_cur, r2_cur], dim=-2)
    a_prev = torch.stack([torch.zeros_like(r0_cur), r1_prev, r2_prev], dim=-2)
    a_prev = torch.where(group0[None, :, None, None], 0.0, a_prev)

    vl = vehicle_l[:, None]
    l_lb = torch.where(group0, vl, lower)
    l_ub = torch.where(group0, vl, upper)
    l_lb = torch.where(is_pad > 0, 0.0, l_lb)
    l_ub = torch.where(is_pad > 0, 0.0, l_ub)
    lb = torch.stack([l_lb, zeros, zeros], dim=-1)
    ub = torch.stack([l_ub, zeros, zeros], dim=-1)
    return structured.BlockBandedQP(p_diag=p_diag, p_off=p_off, q=q,
                                    a_cur=a_cur, a_prev=a_prev, lb=lb, ub=ub)


def post_smooth_batched(layers_s, lower, upper, vehicle_l, n_layers,
                        config: PlannerConfig,
                        settings: admm.QPSettings = admm.QPSettings(),
                        stats: dict | None = None):
    """Solve the batch; returns (l (B, L), ok, converged). ``stats``, if
    given, receives the round count under ``"post_rounds"``."""
    qp = build_post_structured(layers_s, lower, upper, vehicle_l, n_layers,
                               config)
    sol = structured.solve_structured_batched(qp, settings=settings)
    if stats is not None:
        stats["post_rounds"] = sol.rounds
    return sol.v[:, :, 0], n_layers >= 4, sol.converged
