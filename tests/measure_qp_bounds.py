"""What the JAX package's own QP solutions meet against their float64
optimum: the evidence behind ``chip_smoke.FEASIBILITY`` and
``chip_smoke.GAP``. Runs on the CPU, a few minutes at the full batch::

    JAX_PLATFORMS=cpu python tests/measure_qp_bounds.py [--batch 256] \\
        [--cap 3000] [--knots 128] [--route long]

Pass 2 of the path QP (at ``--knots``, the default 128) on the adversarial
batch: the port's stages up to its pass 1, then pass 2 by both packages
(the JAX stage fed the port's geometry), the dense float64 optimum by
``chip_smoke.optimum`` (its adaptive attempt capped at ``--cap``
iterations, in chunks of 32 lanes), and, at the default width, the
smoothing families on the 8-lane golden batch
(``test_torch_smoothing_optimality``). Prints one JSON
line per family and solver: the worst violation, the worst violation
beyond the termination band's relative term (2e-3 ||A x*||), the worst
cost gap by the optimum's cost, and the worst ratio to the family's bounds
and to the gridmap test's gap bound, max(1e-4, 5e-3 |cost*|).
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import chip_smoke  # noqa: E402
from test_torch_fixtures import jax_scenarios  # noqa: E402
from test_torch_oracle_parity import jax_pass2  # noqa: E402
from test_torch_smoothing_optimality import build_families  # noqa: E402
from tpu_pathopt.config import PlannerConfig as JaxConfig  # noqa: E402
from tpu_pathopt_torch import maps, pipeline, scenarios  # noqa: E402
from tpu_pathopt_torch.config import PlannerConfig  # noqa: E402
from tpu_pathopt_torch.solver import assembly  # noqa: E402

CHUNK = 32


def stats(family, dense, x, opt) -> dict:
    cert = chip_smoke.certify(family, dense, x, opt.x)
    P, q, A = dense[:3]
    c_star = chip_smoke.qp_cost(P, q, opt.x)
    band = 2e-3 * (A @ opt.x[..., None])[..., 0].abs().amax(-1)
    return dict(cert=cert, c_star=c_star, band=band)


def report(family, solver, parts):
    cat = lambda k: torch.cat([p[k] for p in parts])  # noqa: E731
    cert = {k: torch.cat([p["cert"][k] for p in parts])
            for k in parts[0]["cert"]}
    c, v, g = cat("c_star").abs(), cert["violation"], cert["gap"]
    out = dict(family=family, solver=solver, lanes=len(v),
               worst_violation=float(v.max()),
               worst_beyond_band=float((v - cat("band")).max()),
               worst_violation_over_bound=float(
                   (v / cert["feas_bound"]).max()),
               worst_gap_over_bound=float((g / cert["gap_bound"]).max()),
               gridmap_gap_ratios=[float(r) for r in g / torch.clamp(
                   5e-3 * c, min=1e-4)])
    for lo, hi in ((0.0, 0.1), (0.1, 1.0), (1.0, float("inf"))):
        m = (c >= lo) & (c < hi)
        if bool(m.any()):
            out[f"cost*_in_[{lo},{hi})"] = dict(
                lanes=int(m.sum()), worst_gap=float(g[m].max()),
                worst_rel_gap=float((g / c)[m].max()))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--cap", type=int, default=3000)
    ap.add_argument("--knots", type=int, default=128)
    ap.add_argument("--route", choices=("adversarial", "long"),
                    default="adversarial")
    args = ap.parse_args()
    chip_smoke.ORACLE_SETTINGS = dataclasses.replace(
        chip_smoke.ORACLE_SETTINGS, max_iter=args.cap)

    if args.route == "long":
        kw = scenarios.LONG_CONFIG
        per = 256 // len(scenarios.LANES)
        rows = [c * per + i for c in range(len(scenarios.LANES))
                for i in range(chip_smoke.LONG_ORACLE_PER_CLASS)]
        arrays = {k: v[rows] for k, v in
                  scenarios.long_route_arrays(256).items()}
        gm = maps.build_map(scenarios.long_route_mask(),
                            resolution=scenarios.RESOLUTION,
                            pad_shape=scenarios.PAD_SHAPE, device="cpu")
        scs = scenarios.scenario_batch(arrays, "cpu")
        scs_j = jax_scenarios(arrays)
        args.batch = len(rows)
    else:
        kw = dict(n_knots=args.knots)
        if args.knots == PlannerConfig().n_knots:
            for family, (dense, opt, sols) in build_families().items():
                for solver, (x, _) in sols.items():
                    report(family, solver, [stats(family, dense, x, opt)])
        gm, scs, _ = scenarios.build_adversarial(args.batch, device="cpu")
        scs_j = None

    family = "path_long" if args.route == "long" else "path"
    cfg = PlannerConfig(**kw)
    st = cfg.qp_settings()
    geo, _ = pipeline.run_to_geometry(gm, scs, cfg, st)
    sol1, sol2 = pipeline.stage_path_qp(scs, geo, cfg, st)
    qp2 = pipeline.build_path_qp(scs, geo, cfg, sol1=sol1)
    xs = {"port": sol2.v.flatten(1),
          "jax": torch.as_tensor(jax_pass2(
              scs, geo, JaxConfig(**kw), scs_j)).flatten(1)}
    parts = {k: [] for k in xs}
    refixed = []
    for c0 in range(0, args.batch, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        dense = tuple(a.double() for a in assembly.to_dense(
            dataclasses.replace(qp2, **{f.name: getattr(qp2, f.name)[sl]
                                        for f in dataclasses.fields(qp2)})))
        opt, redo = chip_smoke.optimum(dense)
        assert bool(opt.converged.all())
        refixed += [c0 + r for r in redo]
        for k, x in xs.items():
            parts[k].append(stats(family, dense, x[sl], opt))
    for k in xs:
        report(family, k, parts[k])
    print(json.dumps(dict(family=family, lanes_rho_fixed=refixed,
                          cap=args.cap)))


if __name__ == "__main__":
    main()
