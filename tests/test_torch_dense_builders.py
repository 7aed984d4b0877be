"""The port's dense QP builders, ``to_dense`` and single-scenario
smoothers against the JAX package's, and the counterparts of
``tests/test_structured.py`` (dense and block-banded forms reach the
oracle's optimum).

Tolerances: the builders are the same float32 arithmetic in another
order, held to 1e-6 absolute plus 1e-6 relative (a few float32 ulps of the
largest entries, the weights 1000 and 50 x 9); ``to_dense`` copies entries
and is held bit for bit on the same blocks; the smoothers are float32 ADMM
solves of the same QP at the 2e-3 tolerance, held to the converged flag
and to 5e-3 (the port's round tolerance for 25 float32 iterations in
another order); the oracle comparisons keep ``test_structured.py``'s 2e-2.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt import maps as jmaps
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.smoothing import tension as jtension
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt_torch import convert, maps
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import btridiag, oracle, structured
from tpu_pathopt_torch.smoothing import post_smooth, tension, tension2
from tpu_pathopt_torch.solver import assembly

from test_torch_qp import N, path_inputs, smoothing_inputs

# tpu_pathopt.smoothing's __init__ binds the names post_smooth and
# tension2_smooth to functions, so the modules are taken from sys.modules.
jpost = sys.modules["tpu_pathopt.smoothing.post_smooth"]
jtension2 = sys.modules["tpu_pathopt.smoothing.tension2"]

CFG, JCFG = PlannerConfig(), JaxConfig()
BUILD_TOL = dict(atol=1e-6, rtol=1e-6)


def t(a):
    return convert.tensor(np.array(a), "cpu")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def tension_inputs():
    """Both packages' map of a 32 m square with two obstacles by the
    curves, and TENSION inputs (B = 2, M = 24) along seeded curves."""
    mask = np.zeros((160, 160), bool)
    mask[40:50, 70:80] = True
    mask[75:85, 30:45] = True
    tq, _ = smoothing_inputs()
    x = tq["x"] - 12.5
    return (jmaps.build_map(jnp.asarray(mask), resolution=0.2),
            maps.build_map(mask, resolution=0.2, device="cpu"),
            (x, tq["y"], tq["ang"], tq["nv"]))


def builders():
    """(name, the JAX dense QPs (vmapped), the port's) of each family."""
    tq, pq = smoothing_inputs()
    gm_j, gm, tn = tension_inputs()
    return [
        ("tension2", jax.vmap(lambda *a: jtension2.build_tension2_qp(
            *a, JCFG))(*tq.values()),
         tension2.build_tension2_qp(*(t(v) for v in tq.values()), CFG)),
        ("post", jax.vmap(lambda *a: jpost.build_post_qp(*a, JCFG))(
            *pq.values()),
         post_smooth.build_post_qp(*(t(v) for v in pq.values()), CFG)),
        ("tension", jax.vmap(lambda *a: jtension.build_tension_qp(
            gm_j, *a, JCFG))(*tn),
         tension.build_tension_qp(gm, *(t(v) for v in tn), CFG)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["tension2", "post",
                                                "tension"])
def test_dense_builders_match_jax(case):
    name, want, got = builders()[case]
    for k, g, w in zip("PqAlu", got, want):
        assert g.shape == w.shape, (name, k)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUILD_TOL,
                                   err_msg=f"{name} {k}")


def structured_qps():
    tq, pq = smoothing_inputs()
    gm_j, _, tn = tension_inputs()
    return [
        jax.vmap(lambda *a: jtension2.build_tension2_structured(*a, JCFG))(
            *tq.values()),
        jax.vmap(lambda *a: jpost.build_post_structured(*a, JCFG))(
            *pq.values()),
        jax.vmap(lambda *a: jtension.build_tension_qp_blocks(gm_j, *a,
                                                             JCFG))(*tn),
    ]


def test_to_dense_matches_jax_bit_for_bit():
    """Both ``to_dense`` functions on the same blocks give the JAX
    package's dense QP exactly: the block-banded ones of the three
    smoothing families and the path QPs of ``test_torch_qp``."""
    for qp_j in structured_qps():
        got = structured.to_dense(convert.block_banded_qp(fields(qp_j),
                                                          "cpu"))
        want = jax.vmap(jstructured.to_dense)(qp_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cfg = JaxConfig(n_knots=N)
    qp_j = jax.vmap(lambda d: jassembly.assemble_path_qp(**d, config=cfg))(
        path_inputs())
    got = assembly.to_dense(convert.path_qp(fields(qp_j), "cpu"))
    want = jax.vmap(jassembly.to_dense)(qp_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_path_to_dense_agrees_with_the_structured_operators():
    qp = assembly.assemble_path_qp(**{k: t(v) for k, v in
                                      path_inputs().items()},
                                   config=PlannerConfig(n_knots=N))
    P, q, A, lb, ub = assembly.to_dense(qp)
    rng = np.random.default_rng(4)
    v = t(rng.normal(size=(4, N, 6)))
    zk, ze = assembly.a_mul(qp, v)
    Av = (A @ v.reshape(4, -1, 1))[..., 0]
    np.testing.assert_allclose(Av.numpy(), torch.cat(
        [zk.reshape(4, -1), ze], 1).numpy(), atol=1e-5, rtol=1e-6)
    w = t(rng.normal(size=(4, 6 * N + 2)))
    np.testing.assert_allclose(
        (A.mT @ w[..., None])[..., 0].numpy(),
        assembly.at_mul(qp, w[:, :-2].reshape(4, N, 6), w[:, -2:]).reshape(
            4, -1).numpy(), atol=1e-5, rtol=1e-6)
    lk, uk, le, ue = assembly.bounds(qp)
    np.testing.assert_array_equal(lb.numpy(), torch.cat(
        [lk.reshape(4, -1), le], 1).numpy())
    assert not q.any() and bool((torch.diagonal(P, dim1=1, dim2=2) ==
                                 qp.p_diag.reshape(4, -1)).all())


def test_tension2_smooth_matches_jax():
    tq, _ = smoothing_inputs()
    for b in range(2):
        args = [v[b] for v in tq.values()]
        want = jtension2.tension2_smooth(*args, JCFG)
        got = tension2.tension2_smooth(*(t(a) for a in args), CFG)
        assert bool(got[4]) and bool(want[4])
        assert int(got[3]) == int(want[3])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3)


def test_post_smooth_matches_jax():
    _, pq = smoothing_inputs()
    for b in range(2):
        args = [v[b] for v in pq.values()]
        l_j, ok_j, conv_j = jpost.post_smooth(*args, JCFG)
        l, ok, conv = post_smooth.post_smooth(*(t(a) for a in args), CFG)
        assert bool(conv) and bool(conv_j) and bool(ok) == bool(ok_j)
        np.testing.assert_allclose(l.numpy(), np.asarray(l_j), atol=5e-3)


def _tension2_inputs(M=24, n_valid=20, seed=0):
    """``tests/test_structured.py``'s inputs, batch of one."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 1, M)
    x = 30.0 * u + rng.normal(scale=0.1, size=M)
    y = 2.0 * np.sin(3 * u) + rng.normal(scale=0.1, size=M)
    dx, dy = np.gradient(x), np.gradient(y)
    ang = np.arctan2(dy, dx)
    k = np.gradient(ang) / np.maximum(np.hypot(dx, dy), 1e-6)
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    return tuple(t(np.float32(a)[None]) for a in (x, y, ang, k, s)) + (
        torch.tensor([n_valid]),)


def solve_oracle(dense):
    """The port's oracle on the first QP of a dense batch (float64)."""
    res = oracle.solve(*(a[0].double().numpy() for a in dense))
    assert res.status == "solved"
    return res.x


def test_tension2_structured_matches_dense():
    args = _tension2_inputs()
    qp = tension2.build_tension2_structured(*args, CFG)
    x_struct = solve_oracle(structured.to_dense(qp)).reshape(24, 4)
    x_dense = solve_oracle(tension2.build_tension2_qp(*args, CFG))
    # Same optimum for the shared variables (x, y).
    np.testing.assert_allclose(x_struct[:, 0], x_dense[:24], atol=2e-2)
    np.testing.assert_allclose(x_struct[:, 1], x_dense[24:48], atol=2e-2)
    sol = structured.solve_structured_batched(qp)
    assert bool(sol.converged[0])
    np.testing.assert_allclose(sol.v[0, :, :2].numpy(), x_struct[:, :2],
                               atol=2e-2)


def test_post_structured_matches_dense():
    L = 16
    s = t(np.linspace(0, 22, L, dtype=np.float32)[None])
    lower = torch.full((1, L), -2.0)
    upper = torch.full((1, L), 2.0)
    upper[:, 5:8] = 0.5                 # pinch
    args = (s, lower, upper, torch.tensor([-0.4]), torch.tensor([12]))
    qp = post_smooth.build_post_structured(*args, CFG)
    l_struct = solve_oracle(structured.to_dense(qp)).reshape(L, 3)[:, 0]
    l_dense = solve_oracle(post_smooth.build_post_qp(*args, CFG))
    np.testing.assert_allclose(l_struct, l_dense[:L], atol=2e-2)
    batch = structured.BlockBandedQP(**{
        f.name: getattr(qp, f.name).repeat(3, *[1] * (getattr(
            qp, f.name).dim() - 1)) for f in dataclasses.fields(qp)})
    sol = structured.solve_structured_batched(batch)
    assert bool(sol.converged.all())
    np.testing.assert_allclose(sol.v[0, :, 0].numpy(), l_struct, atol=2e-2)


def test_structured_operators_match_dense():
    qp = tension2.build_tension2_structured(
        *_tension2_inputs(M=10, n_valid=9), CFG)
    Ps, qs, As, _, _ = (a[0].numpy() for a in structured.to_dense(qp))
    rng = np.random.default_rng(1)
    v = rng.normal(size=(1, 10, 4)).astype(np.float32)
    w = rng.normal(size=(1, 10, 3)).astype(np.float32)
    for fn, arg, mat in (("a_mul", v, As), ("at_mul", w, As.T),
                         ("p_mul", v, Ps)):
        np.testing.assert_allclose(
            getattr(structured, fn)(qp, t(arg)).numpy().reshape(-1),
            mat @ arg.reshape(-1), atol=1e-4, err_msg=fn)
    rho = np.abs(rng.normal(size=(1, 10, 3))).astype(np.float32) + 0.1
    diag, offp = structured.normal_blocks(qp, t(rho), 1e-6)
    Md = Ps + 1e-6 * np.eye(40) + As.T @ np.diag(rho.reshape(-1)) @ As
    np.testing.assert_allclose(
        btridiag.to_dense(diag, offp[:, 1:])[0].numpy(), Md, atol=1e-3,
        rtol=1e-3)


def test_float32_dense_solver_needs_the_dense_builders_tension2():
    """The dense form of the block-banded TENSION2 QP holds group 0's empty
    theta row (0 = 0), which Ruiz scales by 1e8 an iteration: in float32
    its row scale overflows and neither package's dense solver converges
    on it. On the dense builder's form both converge, with the structured
    solver's flags, which is the form chip_smoke's float32 check solves."""
    from tpu_pathopt.qp import admm as jadmm
    from tpu_pathopt_torch.qp import admm
    tq, _ = smoothing_inputs()
    args = [t(v) for v in tq.values()]
    qp = tension2.build_tension2_structured(*args, CFG)
    dense = structured.to_dense(qp)
    assert int((dense[2].abs().amax(-1) == 0).sum()) == 2
    assert not bool(admm.solve_qp_batched(
        *dense, settings=admm.QPSettings(max_iter=100)).converged.any())
    assert not np.asarray(jadmm.solve_qp_batched(
        *(jnp.asarray(a.numpy()) for a in dense),
        settings=jadmm.QPSettings(max_iter=100)).converged).any()
    dense = tension2.build_tension2_qp(*args, CFG)
    conv = structured.solve_structured_batched(qp).converged
    got = admm.solve_qp_batched(*dense).converged
    want = jadmm.solve_qp_batched(*(jnp.asarray(a.numpy()) for a in dense))
    assert bool(conv.all())
    np.testing.assert_array_equal(got.numpy(), conv.numpy())
    np.testing.assert_array_equal(np.asarray(want.converged), conv.numpy())
