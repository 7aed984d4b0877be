"""Clamped uniform B-spline evaluation (de Boor), batched (port of
``tpu_pathopt.bspline``; reference: reference_path_smoother.cpp:490-524).

The raw clicked points are the control points of a clamped uniform B-spline
of degree 3/4/5 (chosen per scenario by average point spacing), sampled at
about one point per meter. The JAX package picks the degree's ladder with
``lax.switch``; here all three ladders run over the batch and a ``where``
keeps each scenario's own.
"""

from __future__ import annotations

import torch


def _knot_value(i, degree, denom):
    """Clamped uniform knot value at (possibly out-of-range) index ``i``."""
    return torch.clamp((i.float() - degree) / denom, 0.0, 1.0)


def _de_boor(ctrl, n_valid, degree: int, t):
    """ctrl: (B, N, D) padded control points; n_valid: (B,); t: (B, T).
    Returns (B, T, D)."""
    B, n_max, D = ctrl.shape
    denom = torch.clamp(n_valid - degree, min=1).float().unsqueeze(-1)
    k = torch.floor(t * denom).to(torch.int64) + degree
    k = torch.minimum(torch.clamp(k, min=degree), n_valid.unsqueeze(-1) - 1)

    ctrlp = torch.cat([ctrl.new_zeros(B, degree, D), ctrl], dim=1)
    win = torch.stack([ctrlp[:, j:j + n_max] for j in range(degree + 1)], 2)
    idx = k[:, :, None, None].expand(-1, -1, degree + 1, D)
    d = torch.gather(win, 1, idx)                       # (B, T, degree+1, D)

    for r in range(1, degree + 1):
        cols = []
        for j in range(r, degree + 1):
            lo = _knot_value(j + k - degree, degree, denom)
            hi = _knot_value(j + 1 + k - r, degree, denom)
            den = hi - lo
            alpha = torch.where(torch.abs(den) < 1e-12, 0.0, (t - lo) / den)
            cols.append((1.0 - alpha)[..., None] * d[:, :, j - 1]
                        + alpha[..., None] * d[:, :, j])
        d = torch.cat([d[:, :, :r], torch.stack(cols, dim=2)], dim=2)
    return d[:, :, degree]


def fit_and_sample(x, y, n_valid, n_samples: int):
    """Reference ``bSpline()`` semantics: x, y (B, R) raw points, n_valid
    (B,). Degree 3 if the average spacing is > 10 m, 4 if > 5 m, else 5;
    sampled at dt = 1/length up to t = 1, padded to ``n_samples``.

    Returns (xs, ys, s, n_samples_valid), each batch-leading."""
    x = x.float()
    y = y.float()
    n_valid = n_valid.long()
    ctrl = torch.stack([x, y], dim=-1)                  # (B, R, 2)

    idx = torch.arange(x.shape[-1], device=x.device)
    seg_valid = idx[1:] < n_valid.unsqueeze(-1)
    seg_len = torch.hypot(torch.diff(x, dim=-1), torch.diff(y, dim=-1))
    length = torch.sum(torch.where(seg_valid, seg_len, 0.0), dim=-1)
    avg = length / torch.clamp(n_valid - 1, min=1)
    degree_idx = torch.where(avg > 10.0, 0, torch.where(avg > 5.0, 1, 2))

    i = torch.arange(n_samples, dtype=torch.float32, device=x.device)
    raw_t = i / torch.clamp(length, min=1.0).unsqueeze(-1)
    n_interior = torch.clamp(torch.ceil(length).long(), max=n_samples - 1)
    t = torch.where(i < n_interior.float().unsqueeze(-1), raw_t, 1.0)
    n_samp_valid = n_interior + 1

    pts = None
    for di, degree in enumerate((3, 4, 5)):
        p = _de_boor(ctrl, n_valid, degree, t)
        pts = p if pts is None else torch.where(
            (degree_idx == di)[:, None, None], p, pts)
    xs, ys = pts[..., 0], pts[..., 1]

    seg = torch.hypot(torch.diff(xs, dim=-1), torch.diff(ys, dim=-1))
    samp_idx = torch.arange(n_samples, device=x.device)
    seg = torch.where(samp_idx[1:] < n_samp_valid.unsqueeze(-1), seg, 0.0)
    # Summed in float64 and rounded once to float32, on every device: the
    # CPU's float32 cumsum sums in float64 already, the GPU's in float32 in
    # its own order (splines.refit does the same).
    s = torch.cumsum(seg, -1, dtype=torch.float64).to(seg.dtype)
    s = torch.cat([torch.zeros_like(seg[:, :1]), s], -1)
    return xs, ys, s, n_samp_valid
