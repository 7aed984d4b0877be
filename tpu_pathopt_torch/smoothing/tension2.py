"""TENSION2 smoothing QP in block-banded form, batched (port of
``tpu_pathopt.smoothing.tension2``; reference: tension_smoother_2.cpp).

Variables per point [x, y, theta, k] (nb = 4); rows per point the three
linearized unicycle transitions attached to their later endpoint (r = 3),
with the two start pins folded into group 0:
    x_{i+1} - x_i + ds sin(th_bar_i) theta_i = ds cos(th_bar_i)
    y_{i+1} - y_i - ds cos(th_bar_i) theta_i = ds sin(th_bar_i)
    theta_{i+1} - theta_i - ds k_i = -ds k_bar_i
Cost: deviation from the input x, y + k^2 + (delta k)^2. Padded points are
pinned to their held-last input values. The dense form of the JAX
package is not ported.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured


def build_tension2_structured(x_in, y_in, angle_in, k_in, s_in, n_valid,
                              config: PlannerConfig
                              ) -> structured.BlockBandedQP:
    """Inputs (B, M) and n_valid (B,); returns the batch of QPs."""
    B, M = x_in.shape
    dt, dev = x_in.dtype, x_in.device
    idx = torch.arange(M, device=dev)
    nv = n_valid.long()[:, None]
    w_dev = config.tension_2_deviation_weight
    w_k = config.tension_2_curvature_weight
    w_kr = config.tension_2_curvature_rate_weight

    pair = ((idx <= nv - 3) & (idx < M - 2)).to(dt)               # (B, M)
    pair_im1 = torch.cat([torch.zeros_like(pair[:, :1]), pair[:, :-1]], 1)
    is_pad = (idx >= nv).to(dt)
    has_k = (idx < M - 1).to(dt).expand(B, M)

    k_diag = (2.0 * w_k * has_k + 2.0 * w_kr * (pair + pair_im1)
              + is_pad * has_k + (1.0 - has_k))
    p_diag = torch.diag_embed(torch.stack([
        torch.full((B, M), 2.0 * w_dev, dtype=dt, device=dev),
        torch.full((B, M), 2.0 * w_dev, dtype=dt, device=dev),
        is_pad, k_diag], dim=-1))
    p_off = torch.zeros((B, M, 4, 4), dtype=dt, device=dev)
    p_off[:, :, 3, 3] = -2.0 * w_kr * pair_im1

    zeros = torch.zeros((B, M), dtype=dt, device=dev)
    ones = torch.ones((B, M), dtype=dt, device=dev)
    q = torch.stack([-2.0 * w_dev * x_in, -2.0 * w_dev * y_in, zeros, zeros],
                    dim=-1)

    # Transition data for group i (i >= 1) comes from segment i-1.
    ds = torch.diff(s_in, dim=-1)
    ds = torch.where(ds > 1e-6, ds, 1.0)
    ds = torch.cat([ds[:, :1], ds], dim=1)
    th = torch.cat([angle_in[:, :1], angle_in[:, :-1]], dim=1)
    kb = torch.cat([k_in[:, :1], k_in[:, :-1]], dim=1)
    sin_a, cos_a = torch.sin(th), torch.cos(th)
    valid = (idx >= 1) & (idx <= nv - 1)                          # (B, M)

    eye3x4 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                        torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    a_cur = eye3x4.expand(B, M, 3, 4).clone()
    a_cur[:, 0, 2] = 0.0
    ap = torch.stack([
        torch.stack([-ones, zeros, ds * sin_a, zeros], -1),
        torch.stack([zeros, -ones, -ds * cos_a, zeros], -1),
        torch.stack([zeros, zeros, -ones, -ds], -1),
    ], dim=-2)                                                    # (B, M, 3, 4)
    a_prev = torch.where(valid[..., None, None], ap, 0.0)

    b_valid = torch.stack([ds * cos_a, ds * sin_a, -ds * kb], -1)
    b_pad = torch.stack([x_in, y_in, zeros], -1)
    b = torch.where(valid[..., None], b_valid, b_pad)
    b[:, 0] = torch.stack([x_in[:, 0], y_in[:, 0], zeros[:, 0]], -1)
    return structured.BlockBandedQP(p_diag=p_diag, p_off=p_off, q=q,
                                    a_cur=a_cur, a_prev=a_prev, lb=b, ub=b)


def tension2_smooth_batched(x_in, y_in, angle_in, k_in, s_in, n_valid,
                            config: PlannerConfig,
                            settings: admm.QPSettings = admm.QPSettings(),
                            stats: dict | None = None):
    """Solve the batch of TENSION2 QPs; returns (x, y, s, n_valid,
    converged) with s the rebuilt cumulative arc length. ``stats``, if
    given, receives the solver's round count under ``"smooth_rounds"``."""
    qp = build_tension2_structured(x_in, y_in, angle_in, k_in, s_in, n_valid,
                                   config)
    sol = structured.solve_structured_batched(qp, settings=settings)
    if stats is not None:
        stats["smooth_rounds"] = sol.rounds
    x = sol.v[:, :, 0]
    y = sol.v[:, :, 1]
    M = x_in.shape[1]
    seg = torch.hypot(torch.diff(x, dim=-1), torch.diff(y, dim=-1))
    keep = torch.arange(M - 1, device=x.device) <= n_valid[:, None] - 2
    seg = torch.where(keep, seg, 0.0)
    s = torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(seg, -1)], -1)
    return x, y, s, n_valid, sol.converged
