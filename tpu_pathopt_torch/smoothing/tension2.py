"""TENSION2 smoothing QP in block-banded form, batched (port of
``tpu_pathopt.smoothing.tension2``; reference: tension_smoother_2.cpp).

Variables per point [x, y, theta, k] (nb = 4); rows per point the three
linearized unicycle transitions attached to their later endpoint (r = 3),
with the two start pins folded into group 0:
    x_{i+1} - x_i + ds sin(th_bar_i) theta_i = ds cos(th_bar_i)
    y_{i+1} - y_i - ds cos(th_bar_i) theta_i = ds sin(th_bar_i)
    theta_{i+1} - theta_i - ds k_i = -ds k_bar_i
Cost: deviation from the input x, y + k^2 + (delta k)^2. Padded points are
pinned to their held-last input values. The dense form
(:func:`build_tension2_qp`, variables [x(M), y(M), theta(M), k(M-1)]) and
the single-scenario :func:`tension2_smooth` are the yardstick of the
block-banded one; the pipeline runs the block-banded form.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured
from tpu_pathopt_torch.torchutil import EAGER, scalar


def build_tension2_qp(x_in, y_in, angle_in, k_in, s_in, n_valid,
                      config: PlannerConfig):
    """The batch of TENSION2 QPs in dense form (P, q, A, l, u): inputs
    (B, M), n_valid (B,); variables [x(M), y(M), theta(M), k(M-1)], rows
    the x, y and theta transitions and the two start pins
    (tension_smoother_2.cpp:74-158)."""
    B, M = x_in.shape
    dt, dev = x_in.dtype, x_in.device
    idx = torch.arange(M, device=dev)
    nvl = n_valid.long()[:, None]
    w_dev = config.tension_2_deviation_weight
    w_k = config.tension_2_curvature_weight
    w_kr = config.tension_2_curvature_rate_weight
    nv = 4 * M - 1
    nc = 3 * (M - 1) + 2
    xi, yi, ti, ki = 0, M, 2 * M, 3 * M

    # --- Hessian (tension_smoother_2.cpp:74-94) ---
    d = torch.zeros((B, nv), dtype=dt, device=dev)
    d[:, xi:xi + M] = 2.0 * w_dev
    d[:, yi:yi + M] = 2.0 * w_dev
    d[:, ki:] = 2.0 * w_k
    # Curvature-change coupling on valid k pairs (i, i+1), i <= n_valid-3.
    pair = (idx[:M - 2] <= nvl - 3).to(dt)
    kk = torch.zeros((B, M - 1), dtype=dt, device=dev)
    kk[:, :M - 2] += 2.0 * w_kr * pair
    kk[:, 1:] += 2.0 * w_kr * pair
    d[:, ki:] += kk
    P = torch.diag_embed(d)
    off = -2.0 * w_kr * pair
    r2 = idx[:M - 2]
    P[:, ki + r2, ki + r2 + 1] += off
    P[:, ki + r2 + 1, ki + r2] += off
    # Padded theta and k get unit cost for conditioning (their rows pin x
    # and y; theta and k have no rows beyond the valid range).
    pad = (idx >= nvl).to(dt)
    pad_d = torch.zeros((B, nv), dtype=dt, device=dev)
    pad_d[:, ti:ki] = pad
    pad_d[:, ki:] = pad[:, :M - 1]
    P = P + torch.diag_embed(pad_d)

    # --- Gradient (:147-158) ---
    q = torch.zeros((B, nv), dtype=dt, device=dev)
    q[:, xi:xi + M] = -2.0 * w_dev * x_in
    q[:, yi:yi + M] = -2.0 * w_dev * y_in

    # --- Constraints (:96-145) ---
    ds = torch.diff(s_in, dim=-1)
    ds = torch.where(ds > 1e-6, ds, 1.0)
    seg_valid = idx[:M - 1] <= nvl - 2
    sin_a = torch.sin(angle_in[:, :M - 1])
    cos_a = torch.cos(angle_in[:, :M - 1])
    one = torch.where(seg_valid, -1.0, 0.0).to(dt)
    r = idx[:M - 1]
    A = torch.zeros((B, nc, nv), dtype=dt, device=dev)
    for row0, var, coef in ((0, xi, ds * sin_a), (M - 1, yi, -ds * cos_a)):
        A[:, row0 + r, var + r + 1] = 1.0
        A[:, row0 + r, var + r] = one
        A[:, row0 + r, ti + r] = torch.where(seg_valid, coef, 0.0)
    tr = 2 * (M - 1) + r
    A[:, tr, ti + r + 1] = 1.0
    A[:, tr, ti + r] = one
    A[:, tr, ki + r] = torch.where(seg_valid, -ds, 0.0)
    A[:, nc - 2, xi] = 1.0          # start pins
    A[:, nc - 1, yi] = 1.0

    # Equalities; a padded transition row pins point i+1 at its held-last
    # input value (zero heading deviation).
    bx = torch.where(seg_valid, ds * cos_a, x_in[:, 1:])
    by = torch.where(seg_valid, ds * sin_a, y_in[:, 1:])
    bt = torch.where(seg_valid, -ds * k_in[:, :M - 1], 0.0)
    b = torch.cat([bx, by, bt, x_in[:, :1], y_in[:, :1]], dim=1)
    return P, q, A, b, b


def tension2_smooth(x_in, y_in, angle_in, k_in, s_in, n_valid,
                    config: PlannerConfig,
                    settings: admm.QPSettings = admm.QPSettings()):
    """Solve one TENSION2 QP (inputs (M,), no batch axis) in dense form with
    ``admm.solve_qp``; returns (x, y, s, n_valid, converged) with s the
    rebuilt cumulative arc length (tension_smoother_2.cpp:56-71)."""
    M = x_in.shape[0]
    n_valid = scalar(n_valid, device=x_in.device)
    dense = build_tension2_qp(x_in[None], y_in[None], angle_in[None],
                              k_in[None], s_in[None], n_valid.reshape(1),
                              config)
    sol = admm.solve_qp(*(a[0] for a in dense), settings=settings)
    x = sol.x[:M]
    y = sol.x[M:2 * M]
    seg = torch.hypot(torch.diff(x), torch.diff(y))
    seg = torch.where(torch.arange(M - 1, device=x.device) <= n_valid - 2,
                      seg, 0.0)
    s = torch.cat([torch.zeros_like(x[:1]), torch.cumsum(seg, 0)])
    return x, y, s, n_valid, sol.converged


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


def _smoothed(x, y, n_valid, converged):
    """(x, y, s, n_valid, converged) with s the rebuilt cumulative arc
    length of the smoothed points (tension_smoother_2.cpp:56-71)."""
    M = x.shape[1]
    seg = torch.hypot(torch.diff(x, dim=-1), torch.diff(y, dim=-1))
    keep = torch.arange(M - 1, device=x.device) <= n_valid[:, None] - 2
    seg = torch.where(keep, seg, 0.0)
    s = torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(seg, -1)], -1)
    return x, y, s, n_valid, converged


def tension2_smooth_batched(x_in, y_in, angle_in, k_in, s_in, n_valid,
                            config: PlannerConfig,
                            settings: admm.QPSettings = admm.QPSettings(),
                            stats: dict | None = None, drv=EAGER):
    """Solve the batch of TENSION2 QPs; returns (x, y, s, n_valid,
    converged) with s the rebuilt cumulative arc length. ``stats``, if
    given, receives the solver's round count under ``"smooth_rounds"``.
    ``drv`` runs the set-up, the rounds and the finish as its segments
    (``torchutil.Segments``; eager by default)."""
    run = drv("smooth.setup", lambda *a: structured.structured_setup(
        build_tension2_structured(*a, config), settings=settings),
        x_in, y_in, angle_in, k_in, s_in, n_valid)
    run, rounds = structured.solve_structured(drv, "smooth", run, settings)
    if stats is not None:
        stats["smooth_rounds"] = rounds
    return drv("smooth.finish", lambda run, n: _smoothed(
        run.v[:, :, 0], run.v[:, :, 1], n, run.conv), run, n_valid)
