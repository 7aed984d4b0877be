"""TENSION smoothing QP in block-banded form, batched (port of
``tpu_pathopt.smoothing.tension``; reference:
src/reference_path_smoother/tension_smoother.cpp).

Variables [x, y, d] per point, d the lateral offset along the input path's
normal. Cost: 2nd and 3rd finite differences of x and y (:102-126) plus the
deviation d. Rows tie (x, y) to d along the normal (:143-156); |d| is
bounded by the map clearance clamped to 2 m (:163-176), d_0 = 0 and the last
valid d in [-0.5, 0.5] (:159-162).

The 3rd-difference stencil reaches three points back, so grouping points in
triples makes the Hessian block-tridiagonal in 9-variable blocks ([x, y, d]
x 3 points) with 9 rows a group: the structured engine at nb = 9, r = 9,
whose factor and rounds run through K1 and K3. The dense form
(:func:`build_tension_qp`, variables [x(M), y(M), d(M)]) is the yardstick
of the block-banded one; the pipeline never builds it.
"""

from __future__ import annotations

import math

import torch

from tpu_pathopt_torch import maps
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured
from tpu_pathopt_torch.smoothing.tension2 import _smoothed
from tpu_pathopt_torch.torchutil import EAGER, const, scalar

_GRP = 3    # points per block: covers the 3rd-difference reach
_NB = 9     # variables per block ([x, y, d] x 3)


def _d_bounds(gm: maps.GridMap, x_in, y_in, n_valid):
    """Per-point d bounds (B, M) (tension_smoother.cpp:159-176): ESDF
    clearance clamped to 2 m; d_0 = 0; the last valid point in
    [-0.5, 0.5]; padding pinned to 0."""
    M = x_in.shape[-1]
    idx = torch.arange(M, device=x_in.device)
    clear = torch.clamp(maps.obstacle_distance(gm, x_in, y_in), max=2.0)
    d_lb, d_ub = -clear, clear.clone()
    d_lb[:, 0] = 0.0
    d_ub[:, 0] = 0.0
    nv = n_valid[:, None]
    is_last = idx == nv - 1
    d_lb = torch.where(is_last, -0.5, d_lb)
    d_ub = torch.where(is_last, 0.5, d_ub)
    is_pad = idx >= nv
    return (torch.where(is_pad, 0.0, d_lb), torch.where(is_pad, 0.0, d_ub))


def _xy_band(M: int, n_valid, config: PlannerConfig, dt):
    """Lower band (B, M, 4) of the shared x/y difference Hessian:
    band[b, i, o] = H[i, i - o], summed over the valid 2nd-difference
    (3-point) and 3rd-difference (4-point) windows
    (tension_smoother.cpp:108-120), in the JAX package's order."""
    dev = n_valid.device
    dds = const([1.0, -2.0, 1.0], dtype=dt, device=dev)
    ddds = const([-1.0, 3.0, -3.0, 1.0], dtype=dt, device=dev)
    blk2 = config.cartesian_curvature_weight * torch.outer(dds, dds)
    blk3 = config.cartesian_curvature_rate_weight * torch.outer(ddds, ddds)
    nv = n_valid[:, None]
    w2 = (torch.arange(M - 2, device=dev) <= nv - 3).to(dt)      # (B, M-2)
    w3 = (torch.arange(M - 3, device=dev) <= nv - 4).to(dt)
    band = torch.zeros((n_valid.shape[0], M, 4), dtype=dt, device=dev)
    for o1 in range(3):
        for o2 in range(o1 + 1):
            band[:, o1:o1 + M - 2, o1 - o2] += w2 * blk2[o1, o2]
    for o1 in range(4):
        for o2 in range(o1 + 1):
            band[:, o1:o1 + M - 3, o1 - o2] += w3 * blk3[o1, o2]
    return band


def build_tension_qp_blocks(gm: maps.GridMap, x_in, y_in, angle_in, n_valid,
                            config: PlannerConfig
                            ) -> structured.BlockBandedQP:
    """The batch of TENSION QPs as block-banded problems in 3-point groups.
    Inputs (B, M), n_valid (B,).

    Variable v within group g: index 3 l + c with l the local point (0..2,
    global point i = 3 g + l) and c the channel (0 = x, 1 = y, 2 = d). The
    x-x / y-y couplings reach at most 3 points back, so they land in p_diag
    and p_off only; each constraint row touches one point (a_prev = 0)."""
    B, M = x_in.shape
    dt, dev = x_in.dtype, x_in.device
    G = -(-M // _GRP)
    Mp = G * _GRP
    if Mp != M:
        def pad(a):
            return torch.cat([a, a[:, -1:].expand(B, Mp - M)], dim=1)
        x_in, y_in, angle_in = pad(x_in), pad(y_in), pad(angle_in)

    idx = torch.arange(Mp, device=dev)
    band = _xy_band(Mp, n_valid, config, dt)                     # (B, Mp, 4)

    # --- Hessian blocks ---
    l1 = torch.arange(_GRP, device=dev)[:, None]    # (3, 1) local row point
    l2 = torch.arange(_GRP, device=dev)[None, :]    # (1, 3) local col point
    gpt = idx.reshape(G, _GRP)                      # (G, 3) global point

    # p_diag: points 3g+l1, 3g+l2 -> offset |l1-l2| at row max(l1, l2).
    row_pt = torch.maximum(gpt[:, :, None], gpt[:, None, :])     # (G, 3, 3)
    off_d = torch.abs(l1 - l2).expand(G, _GRP, _GRP)
    xy_diag = band[:, row_pt, off_d]                             # (B, G, 3, 3)

    pad_reg = (idx >= n_valid[:, None]).to(dt).reshape(B, G, _GRP)
    w_d = config.cartesian_deviation_weight

    p_diag = torch.zeros((B, G, _NB, _NB), dtype=dt, device=dev)
    for c in range(2):                       # x and y channels share the band
        p_diag[:, :, 3 * l1 + c, 3 * l2 + c] = xy_diag
    # Padding regularization on the x/y diagonal; d diagonal = w_d + it.
    for l in range(_GRP):
        for c in range(2):
            p_diag[:, :, 3 * l + c, 3 * l + c] += pad_reg[:, :, l]
        p_diag[:, :, 3 * l + 2, 3 * l + 2] += w_d + pad_reg[:, :, l]

    # p_off: point 3g+l1 against 3(g-1)+l2 -> offset 3 + l1 - l2 (nonzero
    # only where it is at most 3, i.e. l1 <= l2).
    off_o = 3 + l1 - l2                                          # (3, 3)
    valid_o = off_o <= 3
    off_o_c = torch.where(valid_o, off_o, 0).expand(G, _GRP, _GRP)
    xy_off = torch.where(valid_o, band[:, gpt[:, :, None].expand(
        G, _GRP, _GRP), off_o_c], 0.0)                           # (B, G, 3, 3)
    p_off = torch.zeros((B, G, _NB, _NB), dtype=dt, device=dev)
    for c in range(2):
        p_off[:, :, 3 * l1 + c, 3 * l2 + c] = xy_off
    p_off[:, 0] = 0.0

    # --- Constraints: 3 rows per point, current block only ---
    theta = angle_in + math.pi / 2
    ct = torch.cos(theta).reshape(B, G, _GRP)
    st = torch.sin(theta).reshape(B, G, _GRP)
    a_cur = torch.zeros((B, G, _NB, _NB), dtype=dt, device=dev)
    for l in range(_GRP):
        a_cur[:, :, 3 * l + 0, 3 * l + 0] = 1.0
        a_cur[:, :, 3 * l + 0, 3 * l + 2] = -ct[:, :, l]
        a_cur[:, :, 3 * l + 1, 3 * l + 1] = 1.0
        a_cur[:, :, 3 * l + 1, 3 * l + 2] = -st[:, :, l]
        a_cur[:, :, 3 * l + 2, 3 * l + 2] = 1.0

    d_lb, d_ub = _d_bounds(gm, x_in, y_in, n_valid)
    lb = torch.stack([x_in, y_in, d_lb], dim=-1).reshape(B, G, _NB)
    ub = torch.stack([x_in, y_in, d_ub], dim=-1).reshape(B, G, _NB)
    return structured.BlockBandedQP(
        p_diag=p_diag, p_off=p_off, q=torch.zeros((B, G, _NB), dtype=dt,
                                                  device=dev),
        a_cur=a_cur, a_prev=torch.zeros_like(a_cur), lb=lb, ub=ub)


def build_tension_qp(gm: maps.GridMap, x_in, y_in, angle_in, n_valid,
                     config: PlannerConfig):
    """The batch of TENSION QPs in dense form (P, q, A, l, u): inputs
    (B, M), n_valid (B,); variables [x(M), y(M), d(M)], rows the x and y
    ties to d along the normal and the d bounds (:102-176)."""
    B, M = x_in.shape
    dt, dev = x_in.dtype, x_in.device
    idx = torch.arange(M, device=dev)
    nvl = n_valid.long()[:, None]
    xi, yi, di = 0, M, 2 * M

    P = torch.zeros((B, 3 * M, 3 * M), dtype=dt, device=dev)
    dds = const([1.0, -2.0, 1.0], dtype=dt, device=dev)
    ddds = const([-1.0, 3.0, -3.0, 1.0], dtype=dt, device=dev)
    blk2 = config.cartesian_curvature_weight * torch.outer(dds, dds)
    blk3 = config.cartesian_curvature_rate_weight * torch.outer(ddds, ddds)
    w2 = (idx[:M - 2] <= nvl - 3).to(dt)     # windows of 3 valid points
    w3 = (idx[:M - 3] <= nvl - 4).to(dt)     # windows of 4 valid points
    for base in (xi, yi):
        for w, blk in ((w2, blk2), (w3, blk3)):
            t = idx[:w.shape[1]] + base
            for o1 in range(blk.shape[0]):
                for o2 in range(blk.shape[0]):
                    P[:, t + o1, t + o2] += w * blk[o1, o2]
    pad = (idx >= nvl).to(dt)
    P = P + torch.diag_embed(torch.cat(
        [pad, pad, config.cartesian_deviation_weight + pad], dim=1))

    theta = angle_in + math.pi / 2
    A = torch.zeros((B, 3 * M, 3 * M), dtype=dt, device=dev)
    A[:, idx, xi + idx] = 1.0
    A[:, idx, di + idx] = -torch.cos(theta)
    A[:, M + idx, yi + idx] = 1.0
    A[:, M + idx, di + idx] = -torch.sin(theta)
    A[:, 2 * M + idx, di + idx] = 1.0

    d_lb, d_ub = _d_bounds(gm, x_in, y_in, n_valid)
    return (P, torch.zeros((B, 3 * M), dtype=dt, device=dev), A,
            torch.cat([x_in, y_in, d_lb], dim=1),
            torch.cat([x_in, y_in, d_ub], dim=1))


def _unpack(v, M):
    """(..., G, 9) block solution -> x, y of length M."""
    pts = v.reshape(v.shape[:-2] + (-1, 3))     # (..., Mp, [x, y, d])
    return pts[..., :M, 0], pts[..., :M, 1]


def tension_smooth(gm: maps.GridMap, x_in, y_in, angle_in, n_valid,
                   config: PlannerConfig,
                   settings: admm.QPSettings = admm.QPSettings()):
    """Solve one TENSION QP (inputs without a batch axis); returns (x, y, s,
    n_valid, converged)."""
    out = tension_smooth_batched(
        gm, x_in[None], y_in[None], angle_in[None],
        scalar(n_valid, device=x_in.device).reshape(1), config,
        settings)
    return tuple(a[0] for a in out)


def tension_smooth_batched(gm: maps.GridMap, x_in, y_in, angle_in, n_valid,
                           config: PlannerConfig,
                           settings: admm.QPSettings = admm.QPSettings(),
                           stats: dict | None = None, drv=EAGER):
    """Solve the batch of TENSION QPs (one shared map); returns (x, y, s,
    n_valid, converged) with s the rebuilt cumulative arc length.
    ``stats``, if given, receives the solver's round count under
    ``"smooth_rounds"``. ``drv`` runs the set-up, the rounds and the finish
    as its segments (``torchutil.Segments``; eager by default)."""
    M = x_in.shape[1]
    run = drv("smooth.setup", lambda *a: structured.structured_setup(
        build_tension_qp_blocks(*a, config), settings=settings),
        gm, x_in, y_in, angle_in, n_valid)
    run, rounds = structured.solve_structured(drv, "smooth", run, settings)
    if stats is not None:
        stats["smooth_rounds"] = rounds
    return drv("smooth.finish", lambda run, n: _smoothed(
        *_unpack(run.v, M), n, run.conv), run, n_valid)
