"""Quickstart: batched path optimization with the PyTorch/CUDA port,
``tpu_pathopt_torch`` (the steps of ``examples/quickstart.py``).

Builds a small synthetic obstacle map, solves a batch of scenarios through
the full pipeline (smoothing -> corridor -> bounds -> two-pass path QP),
inspects the per-scenario results, runs one warm-started replanning cycle,
and renders a PNG. Uses reduced static shapes; drop the shape overrides for
the production (reference-default) configuration. Runs on the GPU, through
the port's CUDA kernels, unless told ``--device cpu`` (the kernels' plain
PyTorch versions). Run:

    python examples/quickstart_torch.py [--device cpu] [--out quickstart.png]
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

# Make `python examples/quickstart_torch.py` work from anywhere: the repo
# root (for `tpu_pathopt_torch`) is the script's parent directory, not
# sys.path[0].
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="optional PNG path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import torch

    from tpu_pathopt_torch import maps, pipeline, replan
    from tpu_pathopt_torch.config import PlannerConfig

    dev = args.device

    # --- 1. A grid map: boolean obstacle mask -> ESDF-backed GridMap. ---
    # 40 m x 40 m at 0.4 m/px: corridor walls plus one post mid-lane.
    res, size = 0.4, 100
    mask = np.zeros((size, size), bool)
    yy = (0.5 * size - 0.5 - np.arange(size)) * res   # col -> world y
    xx = (0.5 * size - 0.5 - np.arange(size)) * res   # row -> world x
    mask[:, np.abs(yy) >= 6.0] = True                  # corridor walls
    mask[np.ix_(np.abs(xx - 2.0) <= 1.0, (yy >= -6.0) & (yy <= 1.2))] = True
    gm = maps.build_map(mask, resolution=res, device=dev)

    # --- 2. A scenario batch: raw reference polyline + start/target poses.
    # Every Scenario field has a leading batch axis.
    B, R = 8, 8                              # batch, padded raw-point capacity
    raw_x = np.concatenate([np.linspace(-15, 15, 6), np.full(R - 6, 15.0)])
    rng = np.random.default_rng(0)
    start_y = rng.uniform(-1.5, 1.5, B)
    heading = rng.uniform(-0.2, 0.2, B)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    scs = pipeline.Scenario(
        raw_x=f32(np.tile(raw_x, (B, 1))), raw_y=f32(np.zeros((B, R))),
        n_raw=torch.full((B,), 6, device=dev),
        start_x=f32(np.full(B, -15.0)), start_y=f32(start_y),
        start_heading=f32(heading), start_k=f32(np.zeros(B)),
        target_x=f32(np.full(B, 15.0)), target_y=f32(np.zeros(B)),
        target_heading=f32(np.zeros(B)))

    # --- 3. Solve. PlannerConfig defaults mirror the reference's flags;
    # the overrides shrink the static shapes for a quick demo (production
    # uses the defaults: n_knots=128 etc.). solve_batch_jit captures the
    # pipeline into one CUDA graph on its first call and replays it after.
    cfg = PlannerConfig(n_knots=64, n_segment_points=32, dp_layers=24,
                        bspline_samples=64)
    res_b = pipeline.solve_batch_jit(gm, scs, cfg, device=dev)

    ok = res_b.ok.cpu().numpy()
    print(f"solved {B} scenarios: ok={int(ok.sum())}/{B}, "
          f"blocked={int(res_b.blocked.sum())}, "
          f"mean QP iters={float(res_b.qp_iters.float().mean()):.0f}")
    i = int(np.argmax(ok))
    nv = int(res_b.n_valid[i])
    k = res_b.k[i, :nv].cpu().numpy()
    print(f"scenario {i}: {nv} knots, max |curvature| {np.abs(k).max():.3f} "
          f"(limit {cfg.kappa_limit:.3f})")

    # --- 4. Warm-started replanning (the reference demo's 30 Hz loop): each
    # solve returns the QP solver state for the next one, and the fleet
    # advances 1 m along its solved paths between them.
    # replan.replan_stream drives whole streams of these.
    res2, warm = pipeline.solve_batch_warm(gm, scs, cfg, device=dev)  # cold
    scs2 = replan.advance_scenarios(scs, res2, 1.0)
    res3, _ = pipeline.solve_batch_warm(gm, scs2, cfg, warm=warm, device=dev)
    print(f"replanned (warm): ok={int(res3.ok.sum())}/{B}, "
          f"mean QP iters={float(res3.qp_iters.float().mean()):.0f} "
          f"(vs {float(res2.qp_iters.float().mean()):.0f} cold)")

    # --- 5. Render (needs matplotlib). ---
    if args.out and importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: no PNG written to {args.out}")
    elif args.out:
        from tpu_pathopt_torch import viz
        from tpu_pathopt_torch.torchutil import tree_map
        viz.plot_result(gm, tree_map(lambda a: a[i], res_b),
                        scenario=tree_map(lambda a: a[i], scs),
                        path_out=args.out,
                        title="tpu_pathopt_torch quickstart")
        print(f"wrote {args.out}")

if __name__ == "__main__":
    main()
