"""Post-smoothing QP over the DP corridor in block-banded form, batched
(port of ``tpu_pathopt.smoothing.post_smooth``; reference: postSmooth,
reference_path_smoother.cpp:526-636).

Variables per layer [l, l', l''] (nb = 3); rows per layer (r = 3): the
corridor range plus the two integration chains l_{i+1} - l_i = ds l'_i and
l'_{i+1} - l'_i = ds l''_i attached to their later endpoint; l_0 pinned to
the vehicle's lateral offset. The reference requires >= 4 layers, which the
caller reports through ``ok``. The dense form (:func:`build_post_qp`,
variables [l(L), l'(L), l''(L)]) and the single-scenario
:func:`post_smooth` are the yardstick of the block-banded one; the pipeline
runs the block-banded form.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured
from tpu_pathopt_torch.torchutil import EAGER, scalar


def build_post_qp(layers_s, lower, upper, vehicle_l, n_layers,
                  config: PlannerConfig):
    """The batch of post-smoothing QPs in dense form (P, q, A, l, u):
    layers_s/lower/upper (B, L), vehicle_l/n_layers (B,); variables
    [l(L), l'(L), l''(L)], rows the L corridor ranges and then the two
    integration chains (:587-636). A padded chain row pins l'_i (l''_i)."""
    B, L = layers_s.shape
    dt, dev = layers_s.dtype, layers_s.device
    idx = torch.arange(L, device=dev)
    nl = n_layers.long()[:, None]
    nv, nc = 3 * L, 3 * L - 2
    li, dli, ddli = 0, L, 2 * L

    pad = (idx >= nl).to(dt)
    d = torch.zeros((B, nv), dtype=dt, device=dev)
    d[:, li:dli] = config.post_weight_l
    d[:, dli:ddli] = config.post_weight_dl
    d[:, ddli:] = config.post_weight_ddl + pad
    P = torch.diag_embed(d)
    q = torch.zeros((B, nv), dtype=dt, device=dev)

    ds = torch.diff(layers_s, dim=-1)
    seg_valid = idx[:L - 1] <= nl - 2
    ds = torch.where(seg_valid, torch.where(ds > 1e-6, ds, 1.0), 0.0)
    one = torch.where(seg_valid, 1.0, 0.0).to(dt)

    A = torch.zeros((B, nc, nv), dtype=dt, device=dev)
    A[:, idx, li + idx] = 1.0                       # l ranges (:610-612)
    rr = idx[:L - 1]
    # l and l' chains (:614-624): v_{i+1} - v_i - ds w_i = 0.
    for row0, v, w in ((L, li, dli), (2 * L - 1, dli, ddli)):
        A[:, row0 + rr, v + rr + 1] = one
        A[:, row0 + rr, v + rr] = -one
        A[:, row0 + rr, w + rr] = torch.where(seg_valid, -ds, 1.0)

    # Bounds (:628-635): l_0 pinned to vehicle_l, l in the DP corridor,
    # padded l pinned to 0; the chains are equalities.
    vl = vehicle_l[:, None]
    is_pad = idx >= nl
    l_lb = torch.where(is_pad, 0.0, torch.where(idx == 0, vl, lower))
    l_ub = torch.where(is_pad, 0.0, torch.where(idx == 0, vl, upper))
    zeros = torch.zeros((B, 2 * (L - 1)), dtype=dt, device=dev)
    return (P, q, A, torch.cat([l_lb, zeros], dim=1),
            torch.cat([l_ub, zeros], dim=1))


def post_smooth(layers_s, lower, upper, vehicle_l, n_layers,
                config: PlannerConfig,
                settings: admm.QPSettings = admm.QPSettings()):
    """Solve one post-smoothing QP (inputs without a batch axis) in dense
    form with ``admm.solve_qp``. Returns (l (L,), ok, converged); ok is the
    reference's >= 4 layer requirement."""
    L = layers_s.shape[0]
    n_layers = scalar(n_layers, device=layers_s.device)
    dense = build_post_qp(layers_s[None], lower[None], upper[None],
                          scalar(vehicle_l, layers_s.dtype,
                                 layers_s.device).reshape(1),
                          n_layers.reshape(1), config)
    sol = admm.solve_qp(*(a[0] for a in dense), settings=settings)
    return sol.x[:L], n_layers >= 4, sol.converged


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
                        stats: dict | None = None, drv=EAGER):
    """Solve the batch; returns (l (B, L), ok, converged). ``stats``, if
    given, receives the round count under ``"post_rounds"``. ``drv`` runs
    the set-up, the rounds and the finish as its segments
    (``torchutil.Segments``; eager by default)."""
    run = drv("post.setup", lambda *a: structured.structured_setup(
        build_post_structured(*a, config), settings=settings),
        layers_s, lower, upper, vehicle_l, n_layers)
    run, rounds = structured.solve_structured(drv, "post", run, settings)
    if stats is not None:
        stats["post_rounds"] = rounds
    return drv("post.finish", lambda run, n: (run.v[:, :, 0], n >= 4,
                                              run.conv), run, n_layers)
