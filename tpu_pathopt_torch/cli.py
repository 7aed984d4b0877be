"""Command-line demo (port of ``tpu_pathopt.cli``).

Replaces the reference's interactive RViz node (reference:
src/test/demo.cpp): loads a grid map from a PNG (0 = obstacle, 255 = free,
0.2 m/px, the reference's gridmap.png format) or generates a synthetic
corridor map, builds the ESDF, solves one query through the port's pipeline
and renders the result to a PNG. The solve runs on the GPU; ``--cpu`` asks
for the CPU, where the kernels' plain versions run.

Usage:
    python -m tpu_pathopt_torch.cli --map gridmap.png --out demo.png
    python -m tpu_pathopt_torch.cli --synthetic --batch 64
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import time

import numpy as np
import torch


def load_png_map(path, resolution=0.2, device=None):
    """A GridMap from a PNG, its ESDF built on the host by the native
    runtime (``runtime.native``). PIL is imported here alone."""
    from PIL import Image

    from tpu_pathopt_torch.runtime import native
    img = np.array(Image.open(path).convert("L"))
    return native.build_map_native(img < 128, resolution=resolution,
                                   device=device)


def synthetic_map(size=300, resolution=0.2, device=None):
    """Walls along |y| >= 0.4 of the extent and two blocks in the way."""
    from tpu_pathopt_torch import maps
    mask = np.zeros((size, size), bool)
    yy = (0.5 * size - 0.5 - np.arange(size)) * resolution
    xx = (0.5 * size - 0.5 - np.arange(size)) * resolution
    mask[:, np.abs(yy) >= 0.4 * size * resolution] = True
    mask[np.ix_((xx >= -5) & (xx <= 0), (yy >= -1) & (yy <= 20))] = True
    mask[np.ix_((xx >= 8) & (xx <= 12), (yy <= 1) & (yy >= -20))] = True
    return maps.build_map(mask, resolution=resolution, device=device)


def demo_scenario(raw_points, start, target, n_raw_pad=16, device=None):
    """One query (no batch axis): the raw points padded by repeating the
    last, and (x, y, heading) start and target states."""
    from tpu_pathopt_torch import pipeline
    from tpu_pathopt_torch.torchutil import resolve_device
    dev = resolve_device(device)
    pts = np.asarray(raw_points, np.float32)
    n = len(pts)
    pts = np.concatenate([pts, np.tile(pts[-1], (n_raw_pad - n, 1))])
    f = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    return pipeline.Scenario(
        raw_x=f(pts[:, 0]), raw_y=f(pts[:, 1]),
        n_raw=torch.tensor(n, dtype=torch.int64, device=dev),
        start_x=f(start[0]), start_y=f(start[1]), start_heading=f(start[2]),
        start_k=f(0.0), target_x=f(target[0]), target_y=f(target[1]),
        target_heading=f(target[2]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--map", type=str, default=None,
                        help="PNG obstacle map (0=occupied, 255=free)")
    parser.add_argument("--resolution", type=float, default=0.2)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--out", type=str, default="demo_path.png")
    parser.add_argument("--batch", type=int, default=0,
                        help="also time a batched solve of this size")
    parser.add_argument("--points", type=str, default=None,
                        help="raw ref points as 'x1,y1;x2,y2;...'")
    parser.add_argument("--start", type=str, default=None,
                        help="'x,y,heading'")
    parser.add_argument("--target", type=str, default=None,
                        help="'x,y,heading'")
    parser.add_argument("--profile", action="store_true",
                        help="per-stage timing (the reference's "
                             "TimeRecorder, path_optimizer.cpp:41-69)")
    parser.add_argument("--verbose-qp", action="store_true",
                        help="print the path QP's per-round ADMM residuals "
                             "for this solve (the reference runs OSQP with "
                             "verbose=true, base_solver.cpp:59)")
    parser.add_argument("--small", action="store_true",
                        help="small static shapes (a quick preview)")
    # The reference demo takes its method toggles as gflags
    # (planning_flags.cpp).
    parser.add_argument("--smoothing-method", choices=["TENSION", "TENSION2"],
                        default="TENSION2",
                        help="reference FLAGS_smoothing_method "
                             "(planning_flags.cpp:27)")
    parser.add_argument("--corridor-method", choices=["DP", "ASTAR"],
                        default="DP",
                        help="DP (graphSearchDp, the reference's live path) "
                             "or the A* variant")
    args = parser.parse_args(argv)

    from tpu_pathopt_torch import diagnostics, pipeline, profiling, viz
    from tpu_pathopt_torch.config import PlannerConfig
    from tpu_pathopt_torch.solver.path_solver import trace_path_rounds
    from tpu_pathopt_torch.torchutil import compiled, resolve_device, \
        tree_map

    dev = resolve_device("cpu" if args.cpu else None)
    method_kw = dict(smoothing_method=args.smoothing_method,
                     corridor_method=args.corridor_method)
    cfg = (PlannerConfig(n_knots=64, n_segment_points=32, dp_layers=24,
                         bspline_samples=64, qp_max_iter=1000, **method_kw)
           if args.small else PlannerConfig(**method_kw))
    if args.map:
        gm = load_png_map(args.map, args.resolution, dev)
        # A wide corridor of the reference's gridmap.png (>= 3 m of
        # clearance along the way, found from the ESDF).
        default_pts = [(-62, 56.5), (-55, 56.5), (-48, 56.5), (-41, 56.5),
                       (-34, 56.5), (-28, 56.5), (-22, 56.5)]
        default_start = (-62.0, 56.5, 0.0)
        default_target = (-22.0, 56.5, 0.0)
    else:
        gm = synthetic_map(device=dev)
        default_pts = [(-25, 0), (-18, 0), (-11, 0), (-4, 0), (3, 0),
                       (10, 0), (18, 0), (25, 0)]
        default_start = (-25.0, 0.0, 0.0)
        default_target = (25.0, 0.0, 0.0)

    pts = (default_pts if args.points is None else
           [tuple(map(float, p.split(","))) for p in args.points.split(";")])
    start = (default_start if args.start is None else
             tuple(map(float, args.start.split(","))))
    target = (default_target if args.target is None else
              tuple(map(float, args.target.split(","))))

    sc = demo_scenario(pts, start, target, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    t0 = time.perf_counter()
    result = pipeline.solve_jit(gm, sc, cfg, device=dev)
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = pipeline.solve_jit(gm, sc, cfg, device=dev)
    _sync(dev)
    t_warm = time.perf_counter() - t0
    nv = int(result.n_valid)
    print(f"solve: ok={bool(result.ok)} blocked={bool(result.blocked)} "
          f"knots={nv} qp_iters={int(result.qp_iters)}")
    build = (" (kernel build and capture included)" if dev.type == "cuda"
             else "")
    print(f"timing: first{build} {t_first:.1f}s, warm {t_warm * 1e3:.1f}ms")
    scs1 = tree_map(lambda a: a[None], sc)
    if args.profile:
        # Each stage is a compiled call: the first call captures them.
        pipeline.solve_batch_profiled(gm, scs1, cfg, device=dev)
        rec = profiling.TimeRecorder("pipeline")
        pipeline.solve_batch_profiled(gm, scs1, cfg, recorder=rec,
                                      device=dev)
        print(rec.print_time())
    if args.verbose_qp:
        # The per-round residuals of this solve's pass-1 path QP, the
        # surface OSQP's verbose=true gives the reference
        # (base_solver.cpp:59), from the scalar round body.
        st = cfg.qp_settings()
        geo_out, _ = compiled(
            pipeline.STAGES, ("run_to_geometry", cfg, st),
            lambda drv, gm_, scs_: pipeline.run_to_geometry(
                gm_, scs_, cfg, st, drv=drv)[0], (gm, scs1), dev)
        qp1 = pipeline.build_path_qp(scs1, geo_out, cfg)
        # At most 40 rounds (1000 iterations covers every converging
        # scenario of the adversarial batch), and the trace says when the
        # solve needs more: an unmarked cut would read as non-convergence.
        # Ceil division: the solver runs a last partial round when max_iter
        # is not a multiple of check_every.
        n_rounds = min(40, max(-(-cfg.qp_max_iter // cfg.qp_check_every),
                               1))
        # rho0 = rho_bar_path, as stage_path_qp seeds pass 1. The batched
        # solve runs the kernels' rounds: the same math in another order,
        # which can move a check that sits on the tolerance by a round.
        tr = {k: v[:, 0].cpu().numpy() for k, v in trace_path_rounds(
            qp1, st, n_rounds=n_rounds, rho0=st.rho_bar_path).items()}
        print("path QP pass 1, per-round residuals "
              "(OSQP verbose equivalent):")
        print(f"  {'iter':>5} {'pri_res':>12} {'dua_res':>12} {'rho':>10}")
        converged = False
        for r in range(n_rounds):
            print(f"  {int(tr['iters'][r]):>5} {tr['pri_res'][r]:>12.3e} "
                  f"{tr['dua_res'][r]:>12.3e} {tr['rho_bar'][r]:>10.4f}"
                  + ("   converged" if bool(tr["converged"][r]) else ""))
            if bool(tr["converged"][r]):
                converged = True
                break
        if not converged:
            print(f"  ... trace truncated after {int(tr['iters'][-1])} "
                  f"iterations (solver max_iter {st.max_iter}; not yet "
                  f"converged at the last traced check)")
    if not bool(result.ok):
        # The reference's logBoundsInfo (reference_path_impl.cpp:88-95).
        print(diagnostics.dump_bounds(result))
    if nv:
        k = float(result.k[:nv].abs().max())
        print(f"max |curvature| {k:.4f} (limit {cfg.kappa_limit:.4f})")
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: no PNG written to {args.out}")
    else:
        out = viz.plot_result(gm, result, sc, path_out=args.out, config=cfg)
        print(f"wrote {out}")

    if args.batch:
        B = args.batch
        rng = np.random.default_rng(0)
        offs = torch.as_tensor(rng.uniform(-1.5, 1.5, size=B)
                               .astype(np.float32), device=dev)
        scs = tree_map(lambda a: a.expand((B,) + a.shape).clone(), sc)
        scs.start_y = sc.start_y + offs
        t0 = time.perf_counter()
        pipeline.solve_batch_jit(gm, scs, cfg, device=dev)
        _sync(dev)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch_res = pipeline.solve_batch_jit(gm, scs, cfg, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        n_ok = int(batch_res.ok.sum())
        capture = " (capture included)" if dev.type == "cuda" else ""
        print(f"batch {B}: {n_ok}/{B} ok, first{capture} {t_first:.1f}s, "
              f"run {dt * 1e3:.1f}ms -> {B / dt:.1f} solves/s")


if __name__ == "__main__":
    main()
