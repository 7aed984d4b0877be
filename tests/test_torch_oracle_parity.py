"""The port's pass-2 path-QP solutions on the adversarial batch held to the
float64 optimum: the counterpart of
``tests/test_parity_gridmap.py::test_qp_optimality_parity`` on the
synthetic adversarial map (``scenarios.adversarial_arrays(8)``, two lanes
per class) at ``n_knots = 64`` (a 19.2 m horizon, which reaches the tight
lane's first jut and the slalom lane's first post), and at the default
128 knots with the path family's own bounds.

The port's pipeline runs on the CPU. Each lane's pass-2 QP is built twice:
by the port (``assembly.to_dense``, float32) and independently by
``oracle_pipeline.assemble_path_qp`` on the port's own float64-cast
reference, bounds and pass-1 solution; the two agree to float32 round-off
(1e-5 absolute plus 1e-5 relative: the rows are float32 sums of terms of
order 1). On every ok lane the port's solution is feasible within 5e-3
(eps_abs 2e-3 plus float32 headroom) and its cost within max(1e-4,
5e-3 |cost*|) of an eps = 1e-6 oracle solve: the JAX test's bounds.
Pointwise, kappa within 1e-3 and e_psi within 5e-3 of the two-pass oracle
are held on the lanes where the JAX package's own pass 2, fed the same
inputs, meets them; both easy lanes must be among them.

The horizon decides which bounds the reference meets. At 24 knots the end
rows bind and the optima cost 1e-6 to 0.07: the JAX package's own pass 2
exceeds the cost-gap bound there on two lanes, as the port's does
(``tests/measure_qp_bounds.py --batch 8 --knots 24``). At 32 and 48 knots
the two-pass oracle, at the pipeline's 2e-3 tolerance, stops easy lane
0's pass 2 after one round, further from both packages' e_psi than 5e-3.
At 128 knots both packages' pass 2 exceeds the gap bound on the easy and
blocked lanes (the pass stops after one round), so ``chip_smoke.py``
holds that width to the path family's bounds (``chip_smoke.FEASIBILITY``,
``GAP``), set from the JAX package's own results; the last two tests here
hold both packages to them and show why.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import oracle_pipeline as op
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt import refpath as jrefpath
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.solver import assembly

N_KNOTS = 64
B = 8
CFG, JCFG = PlannerConfig(n_knots=N_KNOTS), JaxConfig(n_knots=N_KNOTS)
EASY = [0, 1]


def f64(a):
    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach")
                      else a, np.float64)


def lane_inputs(geo, scs, b):
    """The oracle pipeline's (ref, cb, init_offset, init_heading_error,
    start_k, target_heading) dicts for lane b, from the port's values."""
    ref, cb, off, herr, _, n_valid = geo
    nv = int(n_valid[b])
    refd = dict(s=f64(ref.s[b]), k=f64(ref.k[b]), heading=f64(ref.heading[b]),
                n_valid=nv)
    cbd = {k: f64(getattr(cb, k)[b]) for k in
           ("front_lb", "front_ub", "rear_lb", "rear_ub")}
    cbd.update(blocked=bool(cb.blocked[b]), n_valid=nv)
    return (refd, cbd, float(off[b]), float(herr[b]), float(scs.start_k[b]),
            float(scs.target_heading[b]))


def restrict(dense, b, nv):
    """Lane b of the port's dense batch on its nv valid knots: the knots'
    variables and rows, then the two end rows."""
    P, q, A, lb, ub = (f64(a[b]) for a in dense)
    rows = np.r_[0:6 * nv, 6 * N_KNOTS, 6 * N_KNOTS + 1]
    cols = np.s_[:6 * nv]
    return P[cols, cols], q[cols], A[rows][:, cols], lb[rows], ub[rows]


def jax_pass2(scs, geo, jcfg=JCFG, scs_j=None):
    """The JAX package's stage_path_qp on the port's geometry outputs
    (``scs_j``: the JAX package's scenarios, by default the adversarial
    batch's)."""
    ref, cb, off, herr, ok_init, n_valid = geo
    to_j = lambda cls, obj: cls(**{  # noqa: E731
        f.name: None if getattr(obj, f.name) is None
        else np.asarray(getattr(obj, f.name).numpy())
        for f in dataclasses.fields(obj)})
    geo_j = (to_j(jrefpath.RefStates, ref),
             to_j(jrefpath.CorridorBounds, cb),
             *(np.asarray(a.numpy()) for a in (off, herr, ok_init)),
             np.asarray(n_valid.numpy(), np.int32))
    if scs_j is None:
        _, scs_j, _ = bench.build_adversarial(len(n_valid))
    _, sol2 = jax.jit(jpipe.stage_path_qp, static_argnames=(
        "config", "settings"))(scs_j, geo_j, jcfg, jcfg.qp_settings())
    return np.array(sol2.v)


def oracle_lane(args):
    """The oracle's assembly of the pass-2 QP and its eps = 1e-6 optimum,
    and the two-pass oracle solve, for one lane."""
    lane, sol1_v = args
    refd, cbd, off, herr, k0, th = lane
    nv = cbd["n_valid"]
    dense = op.assemble_path_qp(refd, cbd, sol1_v[:nv, 0], sol1_v[:nv, 1],
                                sol1_v[:nv, 2], off, herr, k0, th,
                                cbd["blocked"], JCFG)
    opt = op.qp_oracle.solve(*dense, eps_abs=1e-6, eps_rel=1e-6,
                             max_iter=20000)
    _, two = op.solve_path_qp_two_pass(refd, cbd, off, herr, k0, th, JCFG)
    return dense, opt, two


@pytest.fixture(scope="module")
def run():
    gm, scs, _ = scenarios.build_adversarial(B, device="cpu")
    st = CFG.qp_settings()
    geo, (ok_input, ok_smooth, cor, ok_post) = pipeline.run_to_geometry(
        gm, scs, CFG, st)
    sol1, sol2 = pipeline.stage_path_qp(scs, geo, CFG, st)
    ok = (ok_input & ok_smooth & cor.ok & ok_post & geo[4] & sol1.converged
          & sol2.converged).numpy()
    dense = assembly.to_dense(pipeline.build_path_qp(scs, geo, CFG,
                                                     sol1=sol1))
    lanes = [lane_inputs(geo, scs, b) for b in range(B)]
    with ThreadPoolExecutor(4) as ex:
        orc = list(ex.map(oracle_lane, [(lanes[b], f64(sol1.v[b]))
                                        for b in range(B)]))
    return dict(ok=ok, n_valid=geo[5].numpy(), v2=f64(sol2.v), dense=dense,
                orc=orc, jax_v2=jax_pass2(scs, geo))


def test_every_lane_solves(run):
    assert run["ok"].all()
    assert all(o[1].status == "solved" and o[2].status == "solved"
               for o in run["orc"])


@pytest.mark.parametrize("b", range(B))
def test_pass2_qp_matches_the_oracle_assembly(run, b):
    got = restrict(run["dense"], b, int(run["n_valid"][b]))
    for name, g, w in zip("PqAlu", got, run["orc"][b][0]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("b", range(B))
def test_pass2_solution_is_feasible_and_optimal(run, b):
    assert run["ok"][b]
    nv = int(run["n_valid"][b])
    (P, q, A, lb, ub), opt, _ = run["orc"][b]
    assert opt.status == "solved"
    xp = run["v2"][b][:nv].reshape(-1)
    Ax = A @ xp
    assert float(np.maximum(lb - Ax, Ax - ub).max()) < 5e-3
    cost = lambda x: 0.5 * x @ P @ x + q @ x  # noqa: E731
    assert cost(xp) - cost(opt.x) < max(1e-4, 5e-3 * abs(cost(opt.x)))


def test_kappa_and_epsi_match_the_two_pass_oracle_where_jax_does(run):
    held = []
    for b in range(B):
        nv = int(run["n_valid"][b])
        vo = run["orc"][b][2].x.reshape(nv, 6)

        def meets(v):
            v = v[:nv]
            return (np.abs(v[:, 2] - vo[:, 2]).max() < 1e-3
                    and np.abs(v[:, 1] - vo[:, 1]).max() < 5e-3)

        if meets(run["jax_v2"][b]):
            held.append(b)
            assert meets(run["v2"][b]), b
    assert set(EASY) <= set(held), held


@pytest.fixture(scope="module")
def full_width():
    """Pass 2 at the default 128 knots on the golden batch: the dense QPs
    (float64), their optimum (``chip_smoke.optimum``), and the port's and
    the JAX package's solutions (the JAX stage fed the port's geometry)."""
    cfg = PlannerConfig()
    gm, scs, _ = scenarios.build_adversarial(B, device="cpu")
    st = cfg.qp_settings()
    geo, _ = pipeline.run_to_geometry(gm, scs, cfg, st)
    sol1, sol2 = pipeline.stage_path_qp(scs, geo, cfg, st)
    assert bool((sol1.converged & sol2.converged).all())
    dense = tuple(a.double() for a in assembly.to_dense(
        pipeline.build_path_qp(scs, geo, cfg, sol1=sol1)))
    opt, _ = chip_smoke.optimum(dense)
    assert bool(opt.converged.all())
    jax_v = torch.as_tensor(jax_pass2(scs, geo, JaxConfig()))
    return dense, opt, {"port": sol2.v.flatten(1), "jax": jax_v.flatten(1)}


@pytest.mark.parametrize("solver", ["port", "jax"])
def test_pass2_at_full_width_meets_the_path_bound(full_width, solver):
    """Both packages' pass 2 at 128 knots within the path family's bounds
    (``chip_smoke.FEASIBILITY``, ``chip_smoke.GAP``), on every lane."""
    dense, opt, sols = full_width
    cert = chip_smoke.certify("path", dense, sols[solver], opt.x)
    assert bool(chip_smoke.certified(cert, torch.ones(B, dtype=bool)).all()
                ), {k: v.tolist() for k, v in cert.items()}


def test_pass2_at_full_width_misses_the_gridmap_bounds(full_width):
    """Why the path family has bounds of its own: at 128 knots the JAX
    package's own pass 2 exceeds the gridmap test's cost-gap bound,
    max(1e-4, 5e-3 |cost*|), on the easy and blocked lanes (by more than
    10x), where the pass stops after one round of 25 iterations and the
    optimum costs little."""
    dense, opt, sols = full_width
    P, q = dense[:2]
    c_star = chip_smoke.qp_cost(P, q, opt.x)
    gap = chip_smoke.qp_cost(P, q, sols["jax"].double()) - c_star
    ratio = gap / torch.clamp(5e-3 * c_star.abs(), min=1e-4)
    assert float(ratio[[0, 1, 6, 7]].min()) > 10.0, ratio.tolist()
