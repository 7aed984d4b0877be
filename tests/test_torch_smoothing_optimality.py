"""The smoothing QPs' solutions held to their float64 optimum, in both
packages, on the golden batch (``bench.build_adversarial(8)``, two lanes
per class): the CPU side of ``chip_smoke.py``'s ``oracle`` phase, which
holds the card's K3 solutions with the same function (``chip_smoke.
certify``) and bounds (``chip_smoke.FEASIBILITY``, ``chip_smoke.GAP``).

The TENSION2, post-smoothing and TENSION QPs are built by the JAX package
from its own stage outputs and converted; their optimum x* is the port's
dense solver in float64 at eps 1e-6, itself held to the NumPy oracle on one
lane of each. The JAX package's structured solutions (its XLA rounds) and
the port's (the kernels' plain versions, and the plain rounds) must meet
every bound on every lane. The pass-2 bound, feasibility 5e-3, is one the
JAX package's own post-smoothing and TENSION solutions exceed (both inside
their termination band eps_abs + eps_rel ||A x||), which is why those two
families' bound adds the band's relative term; the test shows it.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import bench
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.smoothing import tension as jtension
from tpu_pathopt_torch import convert
from tpu_pathopt_torch.qp import admm, oracle, structured

from chip_smoke import FEASIBILITY, ORACLE_SETTINGS, certified, certify

jpost = sys.modules["tpu_pathopt.smoothing.post_smooth"]
jtension2 = sys.modules["tpu_pathopt.smoothing.tension2"]
FAMILIES = ("tension2", "post", "tension")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def build_families() -> dict:
    """family -> (its dense QPs (float64), their optimum, solver -> (x,
    converged)) on the golden batch."""
    gm, scs, _ = bench.build_adversarial(8)
    cfg = JaxConfig()
    st = cfg.qp_settings()
    prep = jax.jit(jpipe.stage_prep, static_argnames=("config",))(scs, cfg)
    smooth = jax.jit(jpipe.stage_smooth, static_argnames=(
        "config", "settings"))(gm, prep, cfg, st)
    _, _, cor = jax.jit(jpipe.stage_corridor, static_argnames=("config",))(
        gm, scs, smooth, cfg)
    _, xg, yg, sg, ang, kg, n_seg = prep
    tcfg = JaxConfig(smoothing_method="TENSION")
    qps = {
        "tension2": jax.vmap(lambda *a: jtension2.build_tension2_structured(
            *a, cfg))(xg, yg, ang, kg, sg, n_seg),
        "post": jax.vmap(lambda *a: jpost.build_post_structured(*a, cfg))(
            cor.layers_s, cor.lower, cor.upper, cor.vehicle_l, cor.n_layers),
        "tension": jax.vmap(lambda *a: jtension.build_tension_qp_blocks(
            gm, *a, tcfg))(xg, yg, ang, n_seg)}
    out = {}
    for name, qp_j in qps.items():
        qp = convert.block_banded_qp(fields(qp_j), "cpu")
        dense = tuple(a.double() for a in structured.to_dense(qp))
        opt = admm.solve_qp_batched(*dense, settings=ORACLE_SETTINGS)
        sols = {"jax": jstructured.solve_structured_batched(qp_j,
                                                            settings=st)}
        for key, fused in (("port", True), ("port_plain", False)):
            sols[key] = structured.solve_structured_batched(
                qp, settings=admm.QPSettings(fused_rounds=fused))
        out[name] = (dense, opt, {
            k: (torch.as_tensor(np.array(s.v)).reshape(8, -1),
                torch.as_tensor(np.array(s.converged)))
            for k, s in sols.items()})
    return out


@pytest.fixture(scope="module")
def families():
    return build_families()


@pytest.mark.parametrize("name", FAMILIES)
def test_float64_optimum_is_the_oracles(families, name):
    dense, opt, _ = families[name]
    assert bool(opt.converged.all())
    res = oracle.solve(*(a[0].numpy() for a in dense), eps_abs=1e-6,
                       eps_rel=1e-6, max_iter=20000)
    assert res.status == "solved"
    P, q = dense[0][0].numpy(), dense[1][0].numpy()
    cost = lambda x: 0.5 * x @ P @ x + q @ x  # noqa: E731
    assert abs(cost(opt.x[0].numpy()) - cost(res.x)) <= 1e-6 * abs(
        cost(res.x))


@pytest.mark.parametrize("solver", ["jax", "port", "port_plain"])
@pytest.mark.parametrize("name", FAMILIES)
def test_solutions_meet_their_bounds(families, name, solver):
    dense, opt, sols = families[name]
    x, conv = sols[solver]
    assert bool(conv.all())
    cert = certify(name, dense, x, opt.x)
    assert bool(certified(cert, conv).all()), {
        k: v.tolist() for k, v in cert.items()}


def test_post_and_tension_need_the_band_term(families):
    """The JAX package's own post-smoothing and TENSION solutions exceed
    the pass-2 feasibility bound (5e-3) on this batch; TENSION2's meet
    it."""
    worst = {}
    for name in FAMILIES:
        dense, opt, sols = families[name]
        worst[name] = float(certify(name, dense, *sols["jax"][:1],
                                    opt.x)["violation"].max())
    assert worst["post"] > 5e-3 and worst["tension"] > 5e-3, worst
    assert worst["tension2"] < FEASIBILITY["tension2"][0], worst
