"""Headless visualization of maps, corridors and optimized paths (port of
``tpu_pathopt.viz``).

Replaces the reference's RViz marker pipeline (reference: src/test/demo.cpp:
213-385: path colored by curvature, vehicle rectangles, bound spheres) with
matplotlib PNG rendering. matplotlib is imported by :func:`plot_result`
alone, so the module imports where matplotlib is not installed; tensors on
any device are copied to the host to be drawn.
"""

from __future__ import annotations

import numpy as np


def _np(a):
    """A tensor (any device), array or number as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _extent(gm):
    """Half the map's extent in x and y (meters)."""
    return (0.5 * int(gm.n_rows) * gm.resolution,
            0.5 * int(gm.n_cols) * gm.resolution)


def _draw_corridor(ax, bounds, nv):
    """Per-knot front/rear bound endpoints — the demo's bound spheres
    (demo.cpp:331-375): each bound offset applied along the state normal at
    its axle center."""
    if getattr(bounds, "front_x", None) is None:
        return
    h = _np(bounds.heading)[:nv]
    nx, ny = np.cos(h + np.pi / 2), np.sin(h + np.pi / 2)
    styles = {
        "front": (bounds.front_x, bounds.front_y,
                  bounds.front_lb, bounds.front_ub, "tab:orange"),
        "rear": (bounds.rear_x, bounds.rear_y,
                 bounds.rear_lb, bounds.rear_ub, "tab:cyan"),
    }
    for name, (cx, cy, lb, ub, color) in styles.items():
        cx = _np(cx)[:nv]
        cy = _np(cy)[:nv]
        lb = _np(lb)[:nv]
        ub = _np(ub)[:nv]
        ax.plot(cx + ub * nx, cy + ub * ny, ".", color=color, ms=2.5,
                zorder=2, label=f"{name} bounds")
        ax.plot(cx + lb * nx, cy + lb * ny, ".", color=color, ms=2.5,
                zorder=2)


def _draw_footprints(ax, x, y, heading, config, every=8):
    """Vehicle rectangles at intervals along the path (demo.cpp:269-313):
    the footprint spans [rear_length, front_length] longitudinally from the
    rear axle and +-car_width/2 laterally."""
    lf, lr = config.front_length, config.rear_length
    w2 = config.car_width / 2.0
    corners = _np([[lf, w2], [lf, -w2], [lr, -w2], [lr, w2], [lf, w2]])
    for i in range(0, len(x), every):
        ch, sh = np.cos(heading[i]), np.sin(heading[i])
        px = x[i] + corners[:, 0] * ch - corners[:, 1] * sh
        py = y[i] + corners[:, 0] * sh + corners[:, 1] * ch
        ax.plot(px, py, "-", color="tab:green", lw=0.7, alpha=0.8, zorder=2)


def plot_result(gm, result, scenario=None, path_out="path.png", title=None,
                config=None, zoom=True):
    """Render ESDF + optimized path (+ raw points / start / target), the
    per-knot collision corridor, vehicle footprints and the blocked-state
    marker — the reference demo's full debugging surface (demo.cpp:213-375).

    ``zoom`` frames the view on the path (+ corridor margin) instead of the
    whole map — the PNG equivalent of zooming the RViz camera; pass False
    for the full-map overview."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    esdf = _np(gm.esdf)[:int(gm.n_rows), :int(gm.n_cols)]
    hx, hy = _extent(gm)
    fig, ax = plt.subplots(figsize=(9, 9))
    # Transpose so horizontal = x, vertical = y; row 0 is max x, col 0 max y.
    # After transpose: array[j, i]; extent maps i -> x (descending), j -> y.
    ax.imshow(esdf.T, origin="upper", cmap="gray",
              extent=(hx, -hx, -hy, hy), vmax=np.percentile(esdf, 90))
    nv = int(result.n_valid)
    x = _np(result.x)[:nv]
    y = _np(result.y)[:nv]
    k = _np(result.k)[:nv]
    heading = _np(result.heading)[:nv]
    if getattr(result, "bounds", None) is not None:
        _draw_corridor(ax, result.bounds, nv)
    if config is not None and nv:
        _draw_footprints(ax, x, y, heading, config)
    if bool(result.blocked) and nv:
        # Blocked-state marker (demo.cpp:315-329): the horizon was truncated
        # at the first zero-width corridor.
        ax.plot(x[-1], y[-1], "rx", ms=14, mew=3, zorder=5, label="BLOCKED")
    sc = ax.scatter(x, y, c=np.abs(k), s=6, cmap="plasma", zorder=3)
    fig.colorbar(sc, ax=ax, label="|curvature| [1/m]", shrink=0.6)
    if zoom and nv:
        # Frame the path + corridor (bounds reach up to ~12 m laterally);
        # the x axis is drawn descending (grid_map convention).
        zx = [x.min(), x.max()]
        zy = [y.min(), y.max()]
        if scenario is not None:
            zx += [float(scenario.start_x), float(scenario.target_x)]
            zy += [float(scenario.start_y), float(scenario.target_y)]
        m = 13.0
        ax.set_xlim(max(zx) + m, min(zx) - m)
        ax.set_ylim(min(zy) - m, max(zy) + m)
    if scenario is not None:
        n_raw = int(scenario.n_raw)
        ax.plot(_np(scenario.raw_x)[:n_raw],
                _np(scenario.raw_y)[:n_raw],
                "c.--", lw=0.8, ms=4, label="raw reference", zorder=2)
        ax.plot(float(scenario.start_x), float(scenario.start_y), "g^",
                ms=10, label="start", zorder=4)
        ax.plot(float(scenario.target_x), float(scenario.target_y), "r*",
                ms=12, label="target", zorder=4)
        ax.legend(loc="upper right")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title or
                 f"optimized path (ok={bool(result.ok)}, "
                 f"blocked={bool(result.blocked)}, n={nv})")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path_out, dpi=110)
    plt.close(fig)
    return path_out
