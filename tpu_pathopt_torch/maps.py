"""Grid map container, exact ESDF construction and bilinear distance lookup
(port of ``tpu_pathopt.maps``; reference: src/tools/Map.cpp:16-22,
src/test/demo.cpp:109-113).

Grid-map convention: image row 0 is max-x, column 0 is max-y, the map is
centered at the origin. The distance transform is an exact Euclidean EDT in
two separable passes (a log-doubling min-plus sweep along rows, then a
chunked min-plus reduction over rows). Every intermediate is an integer
below 2**24 or a single correctly rounded float32 operation, so the result
equals the JAX package's and ``scipy.ndimage.distance_transform_edt``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathopt_torch.torchutil import resolve_device

_INF_PX = 1.0e4  # larger than any realistic map dimension in pixels


@dataclasses.dataclass
class GridMap:
    """Occupancy + ESDF container. ``esdf`` is in meters, zero-padded to a
    canonical shape; ``n_rows``/``n_cols`` are the valid extent. ``quad``
    packs the four bilinear-stencil neighbors of every cell into one row."""

    esdf: torch.Tensor        # (Rp, Cp) float32, meters to nearest obstacle
    quad: torch.Tensor        # ((Rp-1)*(Cp-1), 4) packed stencil rows
    n_rows: int               # valid rows (<= Rp)
    n_cols: int               # valid cols (<= Cp)
    resolution: float = 0.2

    @property
    def shape(self):
        return tuple(self.esdf.shape)

    @property
    def half_extent(self):
        """(half x extent, half y extent) in meters, rounded as float32
        arithmetic rounds them (exact as Python floats)."""
        res = np.float32(self.resolution)
        return (float(np.float32(0.5) * np.float32(self.n_rows) * res),
                float(np.float32(0.5) * np.float32(self.n_cols) * res))


def _one_sided_sweep(d, axis, reverse):
    """d_j = min_k (d_k + |j - k|) restricted to k <= j (or k >= j if
    reverse), in pixels, by in-place log-doubling."""
    n = d.shape[axis]
    pos = torch.arange(n, device=d.device)
    mask_shape = [1] * d.dim()
    mask_shape[axis] = n
    shift = 1
    while shift < n:
        if reverse:
            shifted = torch.roll(d, -shift, dims=axis)
            idx = pos >= n - shift
        else:
            shifted = torch.roll(d, shift, dims=axis)
            idx = pos < shift
        shifted = torch.where(idx.reshape(mask_shape), _INF_PX, shifted)
        d = torch.minimum(d, shifted + shift)
        shift *= 2
    return d


def edt_1d(obstacle_mask, axis):
    """Exact 1D distance (pixels) to the nearest True element along `axis`."""
    d = torch.where(obstacle_mask, 0.0, _INF_PX).float()
    d = _one_sided_sweep(d, axis, reverse=False)
    return _one_sided_sweep(d, axis, reverse=True)


def euclidean_distance_transform(obstacle_mask, chunk: int = 64):
    """Exact 2D EDT in pixels from each cell to the nearest True cell."""
    d1 = edt_1d(obstacle_mask, axis=1)
    d1sq = torch.clamp(d1, max=_INF_PX) ** 2               # (R, C)
    rows = obstacle_mask.shape[0]
    all_i = torch.arange(rows, dtype=torch.float32, device=d1.device)
    out = []
    for start in range(0, rows, chunk):
        out_i = start + torch.arange(chunk, dtype=torch.float32,
                                     device=d1.device)
        w = (out_i[:, None] - all_i[None, :]) ** 2          # (chunk, R)
        out.append(torch.amin(w[:, :, None] + d1sq[None], dim=1))
    return torch.sqrt(torch.cat(out)[:rows])


def pack_quad(esdf):
    """Pack the 4 bilinear neighbors of each (R-1, C-1) cell into one row."""
    e = esdf
    return torch.stack([e[:-1, :-1], e[:-1, 1:], e[1:, :-1], e[1:, 1:]],
                       dim=-1).reshape(-1, 4)


def from_esdf(esdf, resolution: float = 0.2, pad_shape=None,
              device=None) -> GridMap:
    """Wrap a precomputed ESDF (meters) into a GridMap on ``device``.
    ``pad_shape=(Rp, Cp)`` zero-pads bottom/right to a canonical shape; the
    valid extent stays the source shape."""
    esdf = torch.as_tensor(esdf, dtype=torch.float32,
                           device=resolve_device(device))
    r, c = esdf.shape
    if pad_shape is not None:
        pr, pc = pad_shape
        if pr < r or pc < c:
            raise ValueError(f"pad_shape {pad_shape} smaller than map {(r, c)}")
        esdf = torch.nn.functional.pad(esdf, (0, pc - c, 0, pr - r))
    return GridMap(esdf=esdf, quad=pack_quad(esdf), n_rows=int(r),
                   n_cols=int(c), resolution=resolution)


def build_map(obstacle_mask, resolution: float = 0.2, chunk: int = 64,
              pad_shape=None, device=None) -> GridMap:
    """Build a GridMap (ESDF in meters) from a boolean obstacle mask
    (True = occupied) on ``device`` (``cuda`` unless the caller asks for
    another)."""
    mask = torch.as_tensor(obstacle_mask, dtype=torch.bool,
                           device=resolve_device(device))
    esdf = euclidean_distance_transform(mask, chunk=chunk) * resolution
    return from_esdf(esdf, resolution=resolution, pad_shape=pad_shape,
                     device=mask.device)


def grid_map_from_image(img, resolution: float = 0.2, occupied_below: int = 128,
                        pad_shape=None, device=None) -> GridMap:
    """Build from a uint8 grayscale image (0 = obstacle, 255 = free)."""
    img = torch.as_tensor(img)
    return build_map(img < occupied_below, resolution=resolution,
                     pad_shape=pad_shape, device=device)


def position_to_index(gm: GridMap, x, y):
    """Continuous (row, col) index of world position (x, y)."""
    # 0.5 * n - 0.5 is exact in float32 for any map size.
    fi = (0.5 * gm.n_rows - 0.5) - x / gm.resolution
    fj = (0.5 * gm.n_cols - 0.5) - y / gm.resolution
    return fi, fj


def is_inside(gm: GridMap, x, y):
    hx, hy = gm.half_extent
    return (torch.abs(x) <= hx) & (torch.abs(y) <= hy)


def obstacle_distance(gm: GridMap, x, y):
    """Bilinear lookup of the ESDF at world position(s); 0.0 outside the map
    (reference: Map.cpp:16-22). Any shape; one packed-row gather per query."""
    fi, fj = position_to_index(gm, x, y)
    c_pad = gm.esdf.shape[1]
    i0 = torch.clamp(torch.floor(fi).long(), 0, gm.n_rows - 2)
    j0 = torch.clamp(torch.floor(fj).long(), 0, gm.n_cols - 2)
    ti = torch.clamp(fi - i0, 0.0, 1.0)
    tj = torch.clamp(fj - j0, 0.0, 1.0)
    v = gm.quad[(i0 * (c_pad - 1) + j0).reshape(-1)].reshape(
        i0.shape + (4,))
    interp = (v[..., 0] * ((1 - ti) * (1 - tj)) + v[..., 1] * ((1 - ti) * tj)
              + v[..., 2] * (ti * (1 - tj)) + v[..., 3] * (ti * tj))
    return torch.where(is_inside(gm, x, y), interp, 0.0)
