"""Batched natural cubic splines + Newton projections (port of
``tpu_pathopt.splines``; reference: src/tools/spline.cpp, src/tools/tools.cpp).

The batch is written out: every field of a :class:`CubicSpline` carries the
same leading batch shape ``(*batch,)`` and a query ``q`` has shape
``(*batch, *Q)`` for any query shape ``Q``. Segment rows are picked with a
gather (the JAX package's one-hot where-selects exist only for the TPU). A
gather reads only the selected row, so padded rows that hold non-finite
coefficients never poison a query.

The natural-BC tridiagonal system is solved by a sequential Thomas sweep
over the knots, vectorized over the batch. The JAX package runs the same
recurrences as associative scans; the two agree to float32 rounding
(a few 1e-6 relative on the second derivatives), not bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_pathopt_torch.torchutil import take


@dataclasses.dataclass
class CubicSpline:
    """Piecewise cubic y(s) = y_i + c_i t + b_i t^2 + a_i t^3, t = s - s_i on
    [s_i, s_{i+1}]. ``n_valid`` counts real knots; padded knots continue the
    last segment linearly."""

    s: torch.Tensor        # (*batch, N) knot positions, non-decreasing
    y: torch.Tensor        # (*batch, N)
    a: torch.Tensor        # (*batch, N-1)
    b: torch.Tensor        # (*batch, N-1)
    c: torch.Tensor        # (*batch, N-1)
    n_valid: torch.Tensor  # (*batch,) int64

    @property
    def s_max(self):
        return take(self.s, self.n_valid - 1)


def _thomas(lower, diag, upper, rhs):
    """Tridiagonal solve along the last axis (lower[..., 0] and
    upper[..., -1] ignored), sequential over the knots."""
    n = diag.shape[-1]
    cp = [None] * n
    dp = [None] * n
    cp[0] = upper[..., 0] / diag[..., 0]
    dp[0] = rhs[..., 0] / diag[..., 0]
    for i in range(1, n):
        t = diag[..., i] - lower[..., i] * cp[i - 1]
        cp[i] = upper[..., i] / t
        dp[i] = (rhs[..., i] - lower[..., i] * dp[i - 1]) / t
    x = [None] * n
    x[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return torch.stack(x, dim=-1)


def fit_natural(s, y, n_valid) -> CubicSpline:
    """Fit natural cubic splines through (s, y) along the last axis. ``s``
    must be increasing over the first ``n_valid`` entries; entries beyond are
    padding. ``y`` may carry extra leading dims over ``s`` (several curves on
    one knot vector, e.g. x and y stacked)."""
    s = s.expand(y.shape)
    n_valid = n_valid.expand(y.shape[:-1]).long()
    n = s.shape[-1]
    h = torch.diff(s, dim=-1)
    slope = torch.diff(y, dim=-1) / h

    idx = torch.arange(n, device=s.device)
    interior = (idx >= 1) & (idx <= n_valid[..., None] - 2)
    h_im1 = torch.cat([h[..., :1], h], dim=-1)
    h_i = torch.cat([h, h[..., -1:]], dim=-1)
    slope_i = torch.cat([slope, slope[..., -1:]], dim=-1)
    slope_im1 = torch.cat([slope[..., :1], slope], dim=-1)

    diag = torch.where(interior, 2.0 * (h_im1 + h_i), 1.0)
    lower = torch.where(interior, h_im1, 0.0)
    upper = torch.where(interior, h_i, 0.0)
    rhs = torch.where(interior, 6.0 * (slope_i - slope_im1), 0.0)
    sigma = _thomas(lower, diag, upper, rhs)
    sigma = torch.where(interior, sigma, 0.0)

    sig_i = sigma[..., :-1]
    sig_ip1 = sigma[..., 1:]
    a = (sig_ip1 - sig_i) / (6.0 * h)
    b = sig_i / 2.0
    c = slope - h * (2.0 * sig_i + sig_ip1) / 6.0
    return CubicSpline(s=s, y=y, a=a, b=b, c=c, n_valid=n_valid)


def fit_xy(s, x, y, n_valid):
    """(xs, ys): x(s) and y(s) on one knot vector, fitted in one sweep."""
    sp = fit_natural(s, torch.stack([x, y]), n_valid)
    return tuple(CubicSpline(s=sp.s[j], y=sp.y[j], a=sp.a[j], b=sp.b[j],
                             c=sp.c[j], n_valid=sp.n_valid[j]) for j in (0, 1))


def _flat_queries(sp: CubicSpline, q):
    """(rows, q2, shape): spline batch flattened to rows, queries to
    (rows, M), and the query shape to restore."""
    q = torch.as_tensor(q, dtype=sp.s.dtype, device=sp.s.device)
    bshape = sp.s.shape[:-1]
    q = q.expand(bshape + q.shape[len(bshape):]) if q.dim() >= len(bshape) \
        else q.expand(bshape)
    rows = math.prod(bshape)
    return rows, q.reshape(rows, -1), q.shape


def _segment_index(s, n_valid, q2):
    """Segment holding each query (rows, M): the count of knots <= q minus
    one, clipped to the valid segments."""
    i = (q2.unsqueeze(-1) >= s.unsqueeze(1)).sum(-1) - 1
    return torch.minimum(i.clamp(min=0), (n_valid - 2).unsqueeze(-1)).clamp(min=0)


def _rows(sp: CubicSpline, rows):
    n = sp.s.shape[-1]
    return (sp.s.reshape(rows, n), sp.y.reshape(rows, n),
            sp.a.reshape(rows, n - 1), sp.b.reshape(rows, n - 1),
            sp.c.reshape(rows, n - 1), sp.n_valid.reshape(rows))


def _end_slope(s, a, b, c, n_valid):
    hi_i = n_valid - 2
    h_end = take(s, n_valid - 1) - take(s, hi_i)
    return (take(c, hi_i) + 2.0 * take(b, hi_i) * h_end
            + 3.0 * take(a, hi_i) * h_end ** 2)


def evaluate(sp: CubicSpline, q, order: int = 0):
    """Spline value (order=0) or derivative (order=1, 2) at q, with linear
    extrapolation beyond the valid range (tk::spline natural-BC behavior)."""
    rows, q2, shape = _flat_queries(sp, q)
    s, y, a, b, c, nv = _rows(sp, rows)
    i = _segment_index(s, nv, q2)
    t = q2 - torch.gather(s, 1, i)
    ai, bi, ci = (torch.gather(a, 1, i), torch.gather(b, 1, i),
                  torch.gather(c, 1, i))
    s_lo = s[:, :1]
    s_hi = take(s, nv - 1).unsqueeze(-1)
    below = q2 < s_lo
    above = q2 > s_hi
    if order == 0:
        val = torch.gather(y, 1, i) + t * (ci + t * (bi + t * ai))
        lo_val = y[:, :1] + c[:, :1] * (q2 - s_lo)
        hi_val = (take(y, nv - 1).unsqueeze(-1)
                  + _end_slope(s, a, b, c, nv).unsqueeze(-1) * (q2 - s_hi))
        out = torch.where(below, lo_val, torch.where(above, hi_val, val))
    elif order == 1:
        val = ci + t * (2.0 * bi + 3.0 * ai * t)
        hi_val = _end_slope(s, a, b, c, nv).unsqueeze(-1)
        out = torch.where(below, c[:, :1], torch.where(above, hi_val, val))
    elif order == 2:
        val = 2.0 * bi + 6.0 * ai * t
        out = torch.where(below | above, 0.0, val)
    else:
        raise ValueError(f"order must be 0, 1 or 2, got {order}")
    return out.reshape(shape)


def heading(xs: CubicSpline, ys: CubicSpline, q):
    """Tangent direction of the curve (x(s), y(s)) (reference: tools.cpp:32-36)."""
    return torch.atan2(evaluate(ys, q, 1), evaluate(xs, q, 1))


def curvature(xs: CubicSpline, ys: CubicSpline, q):
    """Signed curvature (reference: tools.cpp:38-44)."""
    dx = evaluate(xs, q, 1)
    dy = evaluate(ys, q, 1)
    ddx = evaluate(xs, q, 2)
    ddy = evaluate(ys, q, 2)
    return (dx * ddy - dy * ddx) / (dx * dx + dy * dy) ** 1.5


def pad_arclength(s, n_valid, step: float = 1.0):
    """Make a constant-padded arc-length array (..., N) strictly increasing
    beyond ``n_valid`` so spline fitting stays well-defined on padding."""
    i = torch.arange(s.shape[-1], device=s.device)
    nv = n_valid.unsqueeze(-1)
    s_max = take(s, n_valid - 1).unsqueeze(-1)
    return torch.where(i < nv, s, s_max + step * (i - nv + 1).to(s.dtype))


def pad_polyline(x, y, n_pad: int):
    """Pad polylines (..., n) to length n_pad by continuing the last segment
    direction with the last spacing. Returns (x, y, s, n_valid) with s the
    cumulative arc length."""
    n = x.shape[-1]
    assert n_pad >= n
    dx = x[..., -1:] - x[..., -2:-1]
    dy = y[..., -1:] - y[..., -2:-1]
    extra = torch.arange(1, n_pad - n + 1, dtype=x.dtype, device=x.device)
    x_pad = torch.cat([x, x[..., -1:] + extra * dx], dim=-1)
    y_pad = torch.cat([y, y[..., -1:] + extra * dy], dim=-1)
    seg = torch.hypot(torch.diff(x_pad, dim=-1), torch.diff(y_pad, dim=-1))
    seg = torch.clamp(seg, min=1e-6)
    s = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)], -1)
    n_valid = torch.full(x.shape[:-1], n, dtype=torch.long, device=x.device)
    return x_pad, y_pad, s, n_valid


# ---------------------------------------------------------------------------
# Paired-curve evaluation: x(s) and y(s) share one knot vector, so a query
# needs one segment search and one row gather from a packed table.
# ---------------------------------------------------------------------------


def pack_xy(xs: CubicSpline, ys: CubicSpline):
    """Packed per-segment table [s, x0, xa, xb, xc, y0, ya, yb, yc]
    (*batch, N-1, 9) for :func:`eval_xy_fused`. xs and ys must share the
    knot vector."""
    return torch.stack([xs.s[..., :-1], xs.y[..., :-1], xs.a, xs.b, xs.c,
                        ys.y[..., :-1], ys.a, ys.b, ys.c], dim=-1)


def eval_xy_fused(xs: CubicSpline, ys: CubicSpline, tbl, q):
    """(x, y, dx, dy, ddx, ddy) at q, each shaped like q; semantics identical
    to six :func:`evaluate` calls (incl. linear extrapolation)."""
    rows, q2, shape = _flat_queries(xs, q)
    s, xy_, xa, xb, xc, nv = _rows(xs, rows)
    _, yy_, ya, yb, yc, _ = _rows(ys, rows)
    tb = tbl.reshape(rows, tbl.shape[-2], 9)
    i = _segment_index(s, nv, q2)
    row = torch.gather(tb, 1, i.unsqueeze(-1).expand(-1, -1, 9))
    t = q2 - row[..., 0]

    s_lo = s[:, :1]
    s_hi = take(s, nv - 1).unsqueeze(-1)
    below = q2 < s_lo
    above = q2 > s_hi
    out_of = below | above

    def one(v0, a, b, c, lo_val0, lo_slope, hi_val, hi_slope):
        val = v0 + t * (c + t * (b + t * a))
        d1 = c + t * (2.0 * b + 3.0 * a * t)
        d2 = 2.0 * b + 6.0 * a * t
        lo_val = lo_val0 + lo_slope * (q2 - s_lo)
        hi_v = hi_val + hi_slope * (q2 - s_hi)
        val = torch.where(below, lo_val, torch.where(above, hi_v, val))
        d1 = torch.where(below, lo_slope, torch.where(above, hi_slope, d1))
        d2 = torch.where(out_of, 0.0, d2)
        return val, d1, d2

    x, dx, ddx = one(row[..., 1], row[..., 2], row[..., 3], row[..., 4],
                     xy_[:, :1], xc[:, :1],
                     take(xy_, nv - 1).unsqueeze(-1),
                     _end_slope(s, xa, xb, xc, nv).unsqueeze(-1))
    y, dy, ddy = one(row[..., 5], row[..., 6], row[..., 7], row[..., 8],
                     yy_[:, :1], yc[:, :1],
                     take(yy_, nv - 1).unsqueeze(-1),
                     _end_slope(s, ya, yb, yc, nv).unsqueeze(-1))
    return tuple(o.reshape(shape) for o in (x, y, dx, dy, ddx, ddy))


# ---------------------------------------------------------------------------
# Projections (reference: tools.cpp:66-189)
# ---------------------------------------------------------------------------

def _guard(hes):
    return torch.where(torch.abs(hes) < 1e-12, 1e-12, hes)


def project_newton(xs: CubicSpline, ys: CubicSpline, tx, ty, max_s, hint_s,
                   iters: int = 20):
    """Closest-point projection of (tx, ty) onto the curve by Newton
    iteration from hint_s (getProjectionByNewton, tools.cpp:98-126)."""
    tbl = pack_xy(xs, ys)
    cur = torch.minimum(hint_s, max_s)
    for _ in range(iters):
        x, y, dx, dy, ddx, ddy = eval_xy_fused(xs, ys, tbl, cur)
        jcb = (x - tx) * dx + (y - ty) * dy
        hes = dx * dx + (x - tx) * ddx + dy * dy + (y - ty) * ddy
        cur = cur - jcb / _guard(hes)
    return torch.minimum(cur, max_s)


def project(xs: CubicSpline, ys: CubicSpline, tx, ty, max_s, start_s=0.0,
            grid: float = 1.0, max_grid_points: int = 256, iters: int = 20):
    """Grid pre-scan at `grid` spacing followed by Newton refinement
    (getProjection, tools.cpp:66-96). tx, ty, max_s: (*batch,)."""
    dev = xs.s.device
    cand = start_s + grid * torch.arange(max_grid_points, dtype=torch.float32,
                                         device=dev)
    cand = cand.expand(xs.s.shape[:-1] + (max_grid_points,))
    valid = cand <= max_s.unsqueeze(-1)
    cx = evaluate(xs, cand)
    cy = evaluate(ys, cand)
    d2 = (cx - tx.unsqueeze(-1)) ** 2 + (cy - ty.unsqueeze(-1)) ** 2
    d2 = torch.where(valid, d2, torch.inf)
    best = torch.gather(cand, -1, torch.argmin(d2, dim=-1, keepdim=True))[..., 0]
    return project_newton(xs, ys, tx, ty, max_s, best, iters=iters)


def project_directional(xs: CubicSpline, ys: CubicSpline, tx, ty, angle,
                        max_s, start_s=0.0, grid: float = 1.0,
                        max_grid_points: int = 256, iters: int = 20):
    """Directional projection with a bounded grid pre-scan before the
    Newton polish (getDirectionalProjection, tools.cpp:128-155): scan
    ``max_grid_points`` candidates from ``start_s`` at ``grid`` spacing for
    the least |signed ray distance|, then Newton from the winner. The
    reference's scan never updates its minimum (tools.cpp:147); as in the
    JAX package the minimum is tracked here. tx, ty, angle, max_s and
    start_s share the spline's batch shape and any query shape after it."""
    tx, ty, angle, max_s = (torch.as_tensor(a, dtype=torch.float32,
                                            device=xs.s.device)
                            for a in (tx, ty, angle, max_s))
    offs = grid * torch.arange(max_grid_points, dtype=torch.float32,
                               device=xs.s.device)
    cand = torch.as_tensor(start_s, dtype=torch.float32,
                           device=xs.s.device)[..., None] + offs
    cand = cand.expand(max_s.shape + (max_grid_points,))
    valid = cand <= max_s[..., None]
    cand = torch.minimum(torch.clamp(cand, min=0.0), max_s[..., None])
    cx = evaluate(xs, cand)
    cy = evaluate(ys, cand)
    ray = torch.abs(torch.sin(angle)[..., None] * (cx - tx[..., None])
                    - torch.cos(angle)[..., None] * (cy - ty[..., None]))
    ray = torch.where(valid, ray, torch.inf)
    best = torch.gather(cand, -1, torch.argmin(ray, dim=-1,
                                               keepdim=True))[..., 0]
    return project_directional_newton(xs, ys, tx, ty, angle, max_s, best,
                                      iters=iters)


def directional_ray_residual(xs: CubicSpline, ys: CubicSpline, tx, ty, angle,
                             s):
    """|signed distance of the curve point at s from the ray through (tx, ty)
    along `angle`| — 0 at a true directional projection."""
    x, y, *_ = eval_xy_fused(xs, ys, pack_xy(xs, ys), s)
    return torch.abs(torch.sin(angle) * (x - tx) - torch.cos(angle) * (y - ty))


def project_directional_newton(xs: CubicSpline, ys: CubicSpline, tx, ty, angle,
                               max_s, hint_s, iters: int = 20):
    """Projection along the ray through (tx, ty) with direction `angle`
    (getDirectionalProjectionByNewton, tools.cpp:156-189)."""
    tbl = pack_xy(xs, ys)
    v1 = torch.sin(angle)
    v2 = -torch.cos(angle)
    cur = torch.minimum(hint_s, max_s)
    for _ in range(iters):
        x, y, dx, dy, ddx, ddy = eval_xy_fused(xs, ys, tbl, cur)
        p1 = v1 * (x - tx) + v2 * (y - ty)
        p2 = v1 * dx + v2 * dy
        jcb = p1 * p2
        hes = p1 * (v1 * ddx + v2 * ddy) + p2 * p2
        cur = cur - jcb / _guard(hes)
    return torch.minimum(cur, max_s)
