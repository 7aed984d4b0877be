"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels (interpret mode) and the XLA functions behind them.

The CUDA kernels themselves run only on the GPU; ``chip_smoke.py`` holds each
one against the plain version tested here. On CPU tensors every wrapper runs
its plain version, so calling the wrapper here exercises that dispatch too.
Inputs are the chicane path QPs of ``tests/test_fused_rounds.py`` at N = 24,
small block-banded smoothing QPs, and the randomized DP lattice of
``tests/test_corridor.py`` (dead layers, infinite edges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathopt import corridor as jcorridor
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import btridiag as jbtridiag
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt.smoothing.post_smooth import build_post_structured
from tpu_pathopt.smoothing.tension2 import build_tension2_structured
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import fused_rounds as jfused
from tpu_pathopt_torch import corridor, kernels
from tpu_pathopt_torch.solver import fused_rounds

# K1 as tests/test_fused_rounds.py holds the factor kernel; K2/K3 as it holds
# the rounds (float32 ADMM iterations summed in another order).
FACTOR_TOL = dict(atol=2e-4, rtol=2e-3)
ROUND_TOL = dict(atol=5e-3, rtol=5e-3)
ST = JaxSettings()


def t(a):
    return torch.as_tensor(np.array(a))


def lane(a):
    return jnp.moveaxis(a, 0, -1)


def chicane_qps(shifts, n=24):
    cfg = JaxConfig(n_knots=n)
    s = jnp.arange(n, dtype=jnp.float32) * 0.3
    k = jnp.zeros(n)

    def mk(shift):
        c = jnp.where((s > 3.0) & (s < 6.0), shift, 0.0)
        lb, ub = c - 1.2, c + 1.2
        return jassembly.assemble_path_qp(
            ref_s=s, ref_k=k, ref_heading_last=0.0,
            input_l=jnp.zeros(n), input_e=jnp.zeros(n), input_k=k,
            front_lb=lb, front_ub=ub, rear_lb=lb, rear_ub=ub,
            init_offset=0.0, init_heading_error=0.0, start_k=0.0,
            target_heading=0.0, blocked=False, n_valid=n, config=cfg)

    return jax.vmap(mk)(jnp.asarray(shifts, jnp.float32))


def path_factors(qp):
    B = qp.p_diag.shape[0]
    cls_knot, cls_end = jax.vmap(jassembly.rho_classes)(qp)
    rho_bar = jnp.full((B,), ST.rho_bar, jnp.float32)
    rk = rho_bar[:, None, None] * cls_knot
    re = rho_bar[:, None] * cls_end
    diag, off = jax.vmap(jassembly.normal_blocks, in_axes=(0, 0, 0, None))(
        qp, rk, re, ST.sigma)
    offp = jnp.concatenate([jnp.zeros_like(diag[:, :1]), off], 1)
    return rk, re, diag, offp


def smoothing_qps():
    """A batch of two TENSION2 QPs (nb = 4) and one of two post-smoothing
    QPs (nb = 3) from seeded inputs."""
    cfg = JaxConfig()
    rng = np.random.default_rng(0)
    M = 20
    tq = []
    for nv in (16, 20):
        tt = np.linspace(0, 1, M)
        x = 20.0 * tt + rng.normal(scale=0.1, size=M)
        y = 2.0 * np.sin(3 * tt) + rng.normal(scale=0.1, size=M)
        dx, dy = np.gradient(x), np.gradient(y)
        ang = np.arctan2(dy, dx)
        kk = np.gradient(ang) / np.maximum(np.hypot(dx, dy), 1e-6)
        s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x),
                                                      np.diff(y)))])
        f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        tq.append(build_tension2_structured(f(x), f(y), f(ang), f(kk), f(s),
                                            jnp.asarray(nv, jnp.int32), cfg))
    pq = []
    L = 12
    for nl, vl in ((12, 0.3), (9, -0.5)):
        layers_s = jnp.arange(L, dtype=jnp.float32) * 2.0
        lo = jnp.asarray(rng.uniform(-2.5, -0.5, L), jnp.float32)
        hi = jnp.asarray(rng.uniform(0.5, 2.5, L), jnp.float32)
        pq.append(build_post_structured(layers_s, lo, hi, jnp.float32(vl),
                                        jnp.asarray(nl, jnp.int32), cfg))
    stack = lambda qs: jax.tree_util.tree_map(  # noqa: E731
        lambda *a: jnp.stack(a), *qs)
    return stack(tq), stack(pq)


def structured_factors(qp):
    B = qp.q.shape[0]
    rho = ST.rho_bar * jax.vmap(jstructured.rho_classes)(qp)
    diag, offp = jax.vmap(jstructured.normal_blocks, in_axes=(0, 0, None))(
        qp, rho, ST.sigma)
    assert diag.shape[0] == B
    return rho, diag, offp


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# --------------------------------- K1 ---------------------------------------

@pytest.mark.parametrize("case", ["path_nb6", "tension2_nb4", "post_nb3"])
def test_k1_factor_plain_matches_pallas_and_btridiag(case):
    if case == "path_nb6":
        _, _, diag, offp = path_factors(chicane_qps([0.8, -0.5]))
    else:
        tq, pq = smoothing_qps()
        _, diag, offp = structured_factors(tq if case == "tension2_nb4"
                                           else pq)
    ci_k, wp_k = jfused.fused_factor(lane(diag), lane(offp), interpret=True)
    C, W = jax.vmap(jbtridiag.factor)(diag, offp[:, 1:])
    ci_x, w_x = jbtridiag.inv_factors(C, W)

    ci, wp = fused_rounds.fused_factor(t(lane(diag)), t(lane(offp)))
    assert ci.shape == wp.shape == tuple(diag.shape[1:]) + (diag.shape[0],)
    assert_close(ci, ci_k, FACTOR_TOL)
    assert_close(wp, wp_k, FACTOR_TOL)
    assert_close(fused_rounds.unlane(ci), ci_x, FACTOR_TOL)
    assert_close(fused_rounds.unlane(wp)[:, 1:], w_x, FACTOR_TOL)
    assert not torch.any(wp[0])


# --------------------------------- K2 ---------------------------------------

def test_k2_round_plain_matches_pallas_round_and_residuals():
    qp = chicane_qps([0.8, -0.5, 0.0])
    B, N = qp.p_diag.shape[:2]
    rk, re, diag, offp = path_factors(qp)
    ci_l, wp_l = jfused.fused_factor(lane(diag), lane(offp), interpret=True)
    lbk, ubk, lbe, ube = jax.vmap(jassembly.bounds)(qp)
    rng = np.random.default_rng(1)
    # A mid-solve iterate, so every row type is active.
    v = jnp.asarray(rng.normal(scale=0.1, size=(B, N, 6)), jnp.float32)
    zk, ze = jax.vmap(jassembly.a_mul)(qp, v)
    yk = jnp.asarray(rng.normal(scale=0.05, size=(B, N, 6)), jnp.float32)
    ye = jnp.asarray(rng.normal(scale=0.05, size=(B, 2)), jnp.float32)
    geom = qp.coll_coef[:1, 0, :, 1]
    es = lane((jnp.arange(N)[None, :] == qp.end_idx[:, None])
              .astype(jnp.float32))[:, None, :]
    iters = ST.check_every
    want = jfused.fused_admm_round(
        geom, ci_l, wp_l, lane(qp.t_prev), lane(lbk), lane(ubk), lane(lbe),
        lane(ube), lane(rk), lane(re), es, lane(qp.p_diag), lane(v),
        lane(zk), lane(ze), lane(yk), lane(ye), iters=iters, alpha=ST.alpha,
        sigma=ST.sigma, interpret=True)

    g = np.asarray(geom)[0]
    got = fused_rounds.fused_admm_round(
        (float(g[0]), float(g[1])), t(ci_l), t(wp_l), t(lane(qp.t_prev)),
        t(lane(lbk)), t(lane(ubk)), t(lane(lbe)), t(lane(ube)), t(lane(rk)),
        t(lane(re)), t(qp.end_idx).to(torch.int32), t(lane(qp.p_diag)),
        t(lane(v)), t(lane(zk)), t(lane(ze)), t(lane(yk)), t(lane(ye)),
        iters, ST.alpha, ST.sigma)
    assert len(got) == 6 and got[5].shape == (4, B)
    for a, b in zip(got, want):
        assert a.shape == tuple(b.shape)
        assert_close(a, b, ROUND_TOL)


# --------------------------------- K3 ---------------------------------------

@pytest.mark.parametrize("case", ["tension2_nb4", "post_nb3"])
def test_k3_round_plain_matches_pallas_round(case):
    tq, pq = smoothing_qps()
    qp = tq if case == "tension2_nb4" else pq
    rho, diag, offp = structured_factors(qp)
    ci_l, wp_l = jfused.fused_factor(lane(diag), lane(offp), interpret=True)
    B, N, nb = qp.q.shape
    r = qp.lb.shape[-1]
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.normal(scale=0.1, size=(B, N, nb)), jnp.float32)
    z = jax.vmap(jstructured.a_mul)(qp, v)
    y = jnp.asarray(rng.normal(scale=0.05, size=(B, N, r)), jnp.float32)
    args = (ci_l, wp_l, lane(qp.a_cur), lane(qp.a_prev), lane(qp.q),
            lane(qp.lb), lane(qp.ub), lane(rho), lane(v), lane(z), lane(y))
    want = jfused.fused_structured_round(
        *args, iters=ST.check_every, alpha=ST.alpha, sigma=ST.sigma,
        interpret=True)
    got = fused_rounds.fused_structured_round(
        *(t(a) for a in args), ST.check_every, ST.alpha, ST.sigma)
    for a, b in zip(got, want):
        assert a.shape == tuple(b.shape)
        assert_close(a, b, ROUND_TOL)


# --------------------------------- K4 ---------------------------------------

def random_lattice(seed=7, B=5, lm1=9, K=11):
    """The randomized lattice of tests/test_corridor.py."""
    rng = np.random.default_rng(seed)
    dir_all = rng.uniform(-np.pi, np.pi, (B, lm1, K, K)).astype(np.float32)
    base = rng.uniform(0.0, 3.0, (B, lm1, K, K))
    base[rng.random((B, lm1, K, K)) < 0.3] = jcorridor._INF
    base[1, 4] = jcorridor._INF
    base = base.astype(np.float32)
    h_in = rng.uniform(-np.pi, np.pi, (B, lm1)).astype(np.float32)
    cost0 = np.full((B, K), jcorridor._INF, np.float32)
    cost0[np.arange(B), rng.integers(0, K, B)] = 0.0
    dir0 = np.broadcast_to(rng.uniform(-np.pi, np.pi, (B, 1)),
                           (B, K)).astype(np.float32)
    return dir_all, base, h_in, cost0, dir0


@pytest.mark.parametrize("seed", [7, 8])
def test_k4_dp_forward_plain_matches_scan_and_pallas(seed):
    w1 = JaxConfig().dp_weight_angle_change
    arrs = random_lattice(seed)
    j = tuple(jnp.asarray(a) for a in arrs)
    scan = jax.vmap(lambda d, b, h, c0, d0: jcorridor._dp_forward_scan(
        d, b, h, c0, d0, w1))(*j)
    pallas = jcorridor._dp_forward_pallas(*j, w1, interpret=True)
    got = corridor.dp_forward(*(t(a) for a in arrs), w1)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    assert bool(got[2][:, 3].all()) and not bool(got[2][1, 4:].any())
    for want in (scan, pallas):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_k4_wrap_matches_jnp_mod_bit_for_bit():
    """The DP's angle wrap: torch.remainder (the plain version, and C fmodf
    plus a sign fix in the kernel) equals jnp.mod exactly on float32."""
    from tpu_pathopt import geometry as jgeometry
    from tpu_pathopt_torch import geometry
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-7, 7, 100_000),
                        rng.uniform(-1e3, 1e3, 1000),
                        np.pi * np.arange(-8, 9), [0.0, -0.0]]
                       ).astype(np.float32)
    want = np.asarray(jgeometry.constrain_angle(jnp.asarray(x)))
    got = geometry.constrain_angle(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------ the wrappers --------------------------------

def test_wrappers_count_only_kernel_launches():
    """On CPU tensors a wrapper runs its plain version and counts nothing:
    the counters count launches of the CUDA kernels alone."""
    kernels.reset_launches()
    _, _, diag, offp = path_factors(chicane_qps([0.3]))
    fused_rounds.fused_factor(t(lane(diag)), t(lane(offp)))
    corridor.dp_forward(*(t(a) for a in random_lattice()), 16.0)
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)
    assert set(kernels.launches) == {"fused_factor", "fused_admm_round",
                                     "fused_structured_round", "dp_forward"}


def test_wrappers_reject_other_devices_and_bad_inputs():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kernel_device(torch.zeros(2, device="meta"))
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.expect("x", x, (4, 3), torch.float32, x.device)
    with pytest.raises(ValueError, match="dtype"):
        kernels.expect("x", x.double(), (3, 4), torch.float32, x.device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.expect("x", x.t(), (4, 3), torch.float32, x.device)


def test_kernel_sources_carry_their_notes():
    """Each .cu file names the TPU kernel it replaces, what bounds it on
    the card and what its design does about that; every source is built."""
    for name in kernels.SOURCES:
        text = (kernels.CSRC / name).read_text()
        head = text.split("#include")[0]
        assert "Replaces: tpu_pathopt/" in head, name
        assert "What bounds it" in head, name
        assert "What the design does" in head, name
        assert 'extern "C"' in text, name
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == sorted(
        kernels.SOURCES)
    assert "-gencode" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
