"""Resampling of the B-spline-fit raw reference at 1 m spacing (port of
``tpu_pathopt.smoothing.segment``; reference: segmentRawReference,
reference_path_smoother.cpp:47-85).

Reference quirk kept: the final sample sits at ceil(max_s), up to 1 m past
the fitted range, evaluated by linear extrapolation.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch import splines
from tpu_pathopt_torch.torchutil import take


def segment_raw_reference(x_raw, y_raw, s_raw, n_raw_valid, n_points: int):
    """x_raw/y_raw/s_raw: (B, Mb) padded B-spline samples with cumulative arc
    length; returns (x, y, s, angle, k, n_valid), each (B, n_points) except
    n_valid (B,), sampled at 1 m."""
    xs, ys = splines.fit_xy(s_raw, x_raw, y_raw, n_raw_valid)
    max_s = take(s_raw, n_raw_valid - 1)

    i = torch.arange(n_points, dtype=torch.float32, device=x_raw.device)
    n_valid = torch.clamp(torch.ceil(max_s).long() + 1, max=n_points)
    s = torch.minimum(i, (n_valid - 1).float().unsqueeze(-1))
    x = splines.evaluate(xs, s)
    y = splines.evaluate(ys, s)
    angle = splines.heading(xs, ys, s)
    k = splines.curvature(xs, ys, s)
    return x, y, s, angle, k, n_valid
