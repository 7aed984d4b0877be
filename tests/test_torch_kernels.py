"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels (interpret mode) and the XLA functions behind them.

The CUDA kernels themselves run only on the GPU; ``chip_smoke.py`` holds each
one against the plain version tested here. On CPU tensors every wrapper runs
its plain version, so calling the wrapper here exercises that dispatch too.
Inputs are the chicane path QPs of ``tests/test_fused_rounds.py`` at N = 24,
small block-banded smoothing QPs (also at the top of the adaptive-rho clamp,
and with a zero pivot, where K1's pivot floor decides), the randomized DP
lattice of ``tests/test_corridor.py`` (dead layers, infinite edges) and
``chip_smoke.tie_lattice`` (exact ties). Where a CUDA kernel computes in
another order than its plain version, a model of its order is held here
against the JAX package and a float64 or plain reference.
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
from tpu_pathopt_torch.qp import btridiag
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


def tension_qps():
    """A batch of two TENSION QPs (nb = 9, r = 9; 20 points in 7 groups of
    3) from seeded inputs, their clearance bounds read from a small map
    with two obstacles."""
    from tpu_pathopt import maps as jmaps
    from tpu_pathopt.smoothing.tension import build_tension_qp_blocks
    cfg = JaxConfig()
    mask = np.zeros((120, 120), bool)
    mask[40:50, 70:80] = True
    mask[75:85, 30:45] = True
    gm = jmaps.build_map(jnp.asarray(mask), resolution=0.2)
    rng = np.random.default_rng(4)
    M = 20
    qs = []
    for nv in (17, 20):
        tt = np.linspace(0, 1, M)
        x = -8.0 + 16.0 * tt + rng.normal(scale=0.1, size=M)
        y = 1.5 * np.sin(3 * tt) + rng.normal(scale=0.1, size=M)
        ang = np.arctan2(np.gradient(y), np.gradient(x))
        f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        qs.append(build_tension_qp_blocks(gm, f(x), f(y), f(ang),
                                          jnp.asarray(nv, jnp.int32), cfg))
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qs)


def structured_qp(case):
    """The block-banded test QPs of one K3 shape."""
    if case == "tension_nb9":
        return tension_qps()
    tq, pq = smoothing_qps()
    return tq if case == "tension2_nb4" else pq


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

@pytest.mark.parametrize("case", ["path_nb6", "tension2_nb4", "post_nb3",
                                  "tension_nb9"])
def test_k1_factor_plain_matches_pallas_and_btridiag(case):
    if case == "path_nb6":
        _, _, diag, offp = path_factors(chicane_qps([0.8, -0.5]))
    else:
        _, diag, offp = structured_factors(structured_qp(case))
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


def floor_blocks(case):
    """Float32 K1 inputs (diag, offp), batch-last, on which the Pallas
    kernel's pivot floor sqrt(max(d, 1e-12)) decides the result:
    - "tension2_rho1e6": the TENSION2 test blocks at the top of the
      adaptive-rho clamp, not positive definite in float32, where part of
      the factor is NaN;
    - "zero_pivot": the path-QP blocks at rho_bar 0.1 with row and column 0
      of scenario 1's D_0 set to zero, and column 0 of its first off-block,
      where the floored pivot keeps every entry finite;
    - "zero_pivot_nb9": the same on the TENSION blocks (nb 9)."""
    if case == "tension2_rho1e6":
        diag, off = normal_blocks64("tension2_nb4", 1e6)
    else:
        diag, off = normal_blocks64(
            "tension_nb9" if case == "zero_pivot_nb9" else "path_nb6", 0.1)
        diag[1, 0, 0, :] = 0.0
        diag[1, 0, :, 0] = 0.0
        off[1, 0, :, 0] = 0.0
    diag, off = diag.float(), off.float()
    offp = torch.cat([torch.zeros_like(diag[:, :1]), off], 1)
    return fused_rounds.lane(diag), fused_rounds.lane(offp)


@pytest.mark.parametrize("case", ["tension2_rho1e6", "zero_pivot",
                                  "zero_pivot_nb9"])
def test_k1_factor_plain_keeps_the_pivot_floor(case):
    """K1's plain version computes the Pallas kernel's function where a
    block is not positive definite: the same NaN pattern (cholesky_ex would
    make a whole block NaN) and FACTOR_TOL on every other entry."""
    diag, offp = floor_blocks(case)
    want = jfused.fused_factor(jnp.asarray(diag.numpy()),
                               jnp.asarray(offp.numpy()), interpret=True)
    got = fused_rounds.fused_factor(diag, offp)
    for g, w in zip(got, want):
        w = torch.as_tensor(np.array(w))
        np.testing.assert_array_equal(torch.isnan(g).numpy(),
                                      torch.isnan(w).numpy())
        fin = torch.isfinite(w)
        assert_close(g[fin], w[fin].numpy(), FACTOR_TOL)
    if case.startswith("zero_pivot"):
        assert all(bool(torch.isfinite(g).all()) for g in got)
        assert float(got[0][0, 0, 0, 1]) == pytest.approx(1e6, rel=1e-6)
        C, _ = btridiag.factor(fused_rounds.unlane(diag),
                               fused_rounds.unlane(offp)[:, 1:])
        assert bool(torch.isnan(C[1]).all())
    else:
        assert int(torch.isnan(got[0]).sum()) > 0


def round32(exact):
    """The float32 nearest a Fraction, ties to even."""
    from fractions import Fraction
    f = np.float32(float(exact))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.array(c).view(np.uint32)) & 1))


def test_k1_fma_rounds_once():
    """fused_rounds.fma is x * y + acc rounded once to float32, as the
    kernels' fmaf and XLA's contracted multiply-adds round it, against
    exact rational arithmetic: on random inputs, and on inputs where the
    float64 sum lands on a float32 midpoint that the exact sum lies just
    below or above, so that rounding it to float32 again goes the wrong
    way: x y = +-2^-24 (1 - i^2 2^-46) added to a float32 with an odd last
    bit."""
    from fractions import Fraction
    i = np.arange(1, 301, dtype=np.float64)
    x1 = np.float32(2.0 ** -24) * (1 + i * 2.0 ** -23)
    y1 = 1 - i * 2.0 ** -23
    a1 = np.float32(1 + 2.0 ** -23)
    rng = np.random.default_rng(0)
    x = np.concatenate([x1, -x1, rng.standard_normal(300) * 1e-3])
    y = np.concatenate([y1, y1, rng.standard_normal(300)])
    a = np.concatenate([np.full(300, a1), np.full(300, a1 + 2.0 ** -22),
                        rng.standard_normal(300)])
    x, y, a = (v.astype(np.float32) for v in (x, y, a))
    got = fused_rounds.fma(t(x), t(y), t(a)).numpy()
    twice = (x.astype(np.float64) * y + a).astype(np.float32)
    assert not np.any(got[:600] == twice[:600])
    for i in range(x.size):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) \
            + Fraction(float(a[i]))
        assert got[i] == round32(exact), i


def kernel_order_factor(diag, offp):
    """K1 in the order of its CUDA kernel (csrc/fused_factor.cu), float32,
    batch-last. The sums are factor_plain's (fused_rounds.fma_sum; the
    kernel skips the zero products of the triangular Cinv, which leaves a
    sum of finite terms unchanged). The reciprocals differ: the pivot's is
    one rounding of 1/sqrt (the kernel's rsqrtf is within 2 ulp of it) and
    the inverse multiplies by it in place of dividing by the Cholesky
    diagonal."""
    fma_sum = fused_rounds.fma_sum
    n, nb, _, _ = diag.shape
    floor = torch.tensor(fused_rounds.PIVOT_FLOOR, dtype=diag.dtype)
    cinv, wp = torch.empty_like(diag), torch.empty_like(diag)
    cp = torch.zeros_like(diag[0])
    for i in range(n):
        O = offp[i]
        W = fma_sum([(O[:, None, j], cp[None, :, j]) for j in range(nb)])
        S = diag[i] - fma_sum([(W[:, None, j], W[None, :, j])
                               for j in range(nb)])
        C, inv = torch.zeros_like(S), torch.zeros_like(S[0])
        for j in range(nb):
            e = S[j:, j]
            for k in range(j):
                e = fused_rounds.fma(-C[j:, k], C[j, k], e)
            p = torch.maximum(e[0], floor).double()
            inv[j] = (1.0 / torch.sqrt(p)).float()
            C[j + 1:, j] = e[1:] * inv[j]
        cp = torch.zeros_like(S)
        for j in range(nb):
            cp[j, j] = inv[j]
            for a in range(j + 1, nb):
                acc = fma_sum([(C[a, k], cp[k, j]) for k in range(j, a)])
                cp[a, j] = acc * -inv[a]
        wp[i], cinv[i] = W, cp
    return cinv, wp


@pytest.mark.parametrize("case, rho_bar", [
    (case, rho) for case in ("path_nb6", "tension2_nb4", "post_nb3")
    for rho in (1e-6, 0.1)] + [("tension_nb9", 0.1), ("tension_nb9", 1e6)])
def test_k1_kernel_order_matches_pallas_and_float64(case, rho_bar):
    """The CUDA kernel's order and reciprocals (kernel_order_factor) agree
    with the Pallas kernel in interpret mode and with a float64
    factorization of the same float32 blocks, at FACTOR_TOL, at the four
    block sizes across the adaptive-rho range where the blocks are
    positive definite. The TENSION blocks (nb 9) at rho_bar 1e-6 are not:
    their x and y cost is a difference operator, blind to a shift of the
    whole path, and rho 1e-3 on the tying rows does not make the blocks
    rounded to float32 positive definite (a float64 Cholesky of them
    fails), so they are held at 0.1 and 1e6."""
    diag, off = normal_blocks64(case, rho_bar)
    diag, off = diag.float(), off.float()
    offp = torch.cat([torch.zeros_like(diag[:, :1]), off], 1)
    dl, ol = fused_rounds.lane(diag), fused_rounds.lane(offp)
    ci, wp = kernel_order_factor(dl, ol)
    ci_k, wp_k = jfused.fused_factor(jnp.asarray(dl.numpy()),
                                     jnp.asarray(ol.numpy()), interpret=True)
    assert_close(ci, ci_k, FACTOR_TOL)
    assert_close(wp, wp_k, FACTOR_TOL)
    C, W = btridiag.factor(diag.double(), off.double())
    ci64, w64 = btridiag.inv_factors(C, W)
    assert_close(fused_rounds.unlane(ci), ci64.numpy(), FACTOR_TOL)
    assert_close(fused_rounds.unlane(wp)[:, 1:], w64.numpy(), FACTOR_TOL)


# --------------------------------- K2 ---------------------------------------

def k2_case():
    """A mid-solve K2 round on three chicane QPs: (the torch wrapper's
    arguments, the Pallas kernel's result in interpret mode)."""
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
    args = (fused_rounds.collision_rows(t(qp.coll_coef))[0], t(ci_l),
            t(wp_l), t(lane(qp.t_prev)), t(lane(lbk)), t(lane(ubk)),
            t(lane(lbe)), t(lane(ube)), t(lane(rk)), t(lane(re)),
            t(qp.end_idx).to(torch.int32),
            t(lane(qp.p_diag)), t(lane(v)), t(lane(zk)), t(lane(ze)),
            t(lane(yk)), t(lane(ye)), iters, ST.alpha, ST.sigma)
    return args, want


def test_k2_round_plain_matches_pallas_round_and_residuals():
    args, want = k2_case()
    B = args[1].shape[-1]
    got = fused_rounds.fused_admm_round(*args)
    assert len(got) == 6 and got[5].shape == (4, B)
    for a, b in zip(got, want):
        assert a.shape == tuple(b.shape)
        assert_close(a, b, ROUND_TOL)


# --------------------------------- K3 ---------------------------------------

def k3_case(case):
    """A mid-solve K3 round: (the torch wrapper's arguments, the Pallas
    kernel's result in interpret mode)."""
    qp = structured_qp(case)
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
    return tuple(t(a) for a in args) + (ST.check_every, ST.alpha,
                                        ST.sigma), want


@pytest.mark.parametrize("case", ["tension2_nb4", "post_nb3", "tension_nb9"])
def test_k3_round_plain_matches_pallas_round(case):
    args, want = k3_case(case)
    got = fused_rounds.fused_structured_round(*args)
    for a, b in zip(got, want):
        assert a.shape == tuple(b.shape)
        assert_close(a, b, ROUND_TOL)


def tension_first_round():
    """The arguments of the first K3 call of the port's TENSION solve of the
    golden batch on the CPU: the round that starts from zero."""
    from tpu_pathopt_torch import golden, pipeline, scenarios
    from tpu_pathopt_torch.config import PlannerConfig
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    seen = []
    orig = fused_rounds.fused_structured_round

    def rec(*args, **kw):
        if args[0].shape[1] == 9 and not seen:
            seen.append(tuple(a.clone() for a in args) + tuple(kw.values()))
        return orig(*args, **kw)

    fused_rounds.fused_structured_round = rec
    try:
        pipeline.stage_smooth(gm, pipeline.stage_prep(
            scs, PlannerConfig()), PlannerConfig(smoothing_method="TENSION"),
            PlannerConfig().qp_settings())
    finally:
        fused_rounds.fused_structured_round = orig
    return seen[0]


def pallas_structured_round(args):
    """The Pallas K3 in interpret mode on the torch wrapper's arguments."""
    return tuple(torch.as_tensor(np.array(a)) for a in
                 jfused.fused_structured_round(
                     *(jnp.asarray(a.numpy()) for a in args[:11]),
                     iters=args[11], alpha=args[12], sigma=args[13],
                     interpret=True))


def round_in_kernel_order(args, monkeypatch):
    """structured_round_plain with the K2/K3 kernels' sweep order."""
    with monkeypatch.context() as m:
        m.setattr(fused_rounds.btridiag, "solve_batched", kernel_order_solve)
        return fused_rounds.structured_round_plain(*args)


@pytest.mark.parametrize("order", ["pallas", "kernel_order"])
def test_k3_tension_round_has_a_soft_mode(order, monkeypatch):
    """Why chip_smoke does not hold K3 on the TENSION round of the golden
    batch (READING_ONLY): there the JAX package's own Pallas kernel, and a
    model of the CUDA kernel's sweep order, differ from the plain round
    beyond TOLERANCE, by up to 0.07 m, all of it in d and the coordinate
    tied to it (a straight lane shifted sideways costs the QP almost
    nothing); the duals agree within TOLERANCE."""
    from chip_smoke import compare
    args = tension_first_round()
    assert args[0].shape == (22, 9, 9, 8)
    plain = fused_rounds.structured_round_plain(*args)
    other = (pallas_structured_round(args) if order == "pallas"
             else round_in_kernel_order(args, monkeypatch))
    cmp = compare("fused_structured_round", other, plain)
    assert not cmp["within_tol"] and 0.01 < cmp["max_abs_err"] < 0.07, cmp
    assert compare("fused_structured_round", other[2:], plain[2:])[
        "within_tol"]


def test_tension_fixture_l_moves_with_the_kernels_order(monkeypatch):
    """The soft mode end to end: the port on the CPU with the CUDA kernels'
    orders in place of the plain versions' (kernel_order_factor for K1,
    kernel_order_solve for the K2/K3 sweeps) solves the golden batch under
    TENSION with the TENSION fixture's flags, while its l lands beyond
    golden.TOLERANCES["l"] (0.05 m) from the fixture, where the plain
    versions land within it. So the card's TENSION l is held at
    golden.FIXTURE_TOLERANCES, and K3 at (9, 9) on conditioned inputs."""
    from tpu_pathopt_torch import golden, pipeline, scenarios
    from tpu_pathopt_torch.config import PlannerConfig
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    cfg = PlannerConfig(**golden.CONFIGS["tension"])
    want = golden.load(golden.FIXTURES["tension"])
    plain = golden.arrays(pipeline.solve_batch(gm, scs, cfg, device="cpu"))
    failures, diffs = golden.compare(plain, want)
    assert not failures, (failures, diffs)
    monkeypatch.setattr(fused_rounds, "factor_plain", kernel_order_factor)
    monkeypatch.setattr(fused_rounds.btridiag, "solve_batched",
                        kernel_order_solve)
    got = golden.arrays(pipeline.solve_batch(gm, scs, cfg, device="cpu"))
    failures, diffs = golden.compare(got, want)
    assert not [f for f in failures if f.split(":")[0] in golden.FLAG_FIELDS]
    assert diffs["l"] > golden.TOLERANCES["l"], diffs


@pytest.mark.parametrize("order", ["pallas", "kernel_order"])
def test_k3_conditioned_tension_round_is_held_elementwise(order, monkeypatch):
    """chip_smoke's conditioned_tension_round (at B = 16 here; N 22 as on
    the main path) is a (9, 9) round on which other float32 orders, the
    Pallas kernel's and the CUDA kernel's sweep order, stay within
    TOLERANCE of the plain round elementwise, so the card holds K3 at
    (9, 9) there."""
    from chip_smoke import compare, conditioned_tension_round
    args = conditioned_tension_round(16, "cpu")
    assert args[0].shape == (22, 9, 9, 16) and args[2].shape[1] == 9
    plain = fused_rounds.structured_round_plain(*args)
    other = (pallas_structured_round(args) if order == "pallas"
             else round_in_kernel_order(args, monkeypatch))
    cmp = compare("fused_structured_round", other, plain)
    assert cmp["within_tol"] and cmp["exact_int_outputs"], cmp


@pytest.mark.parametrize("fault", ["d_bounds+0.02", "d_coupling*1.001"])
def test_k3_conditioned_check_sees_d_row_faults(fault):
    """A round that is wrong in the d rows fails chip_smoke's (9, 9) check:
    the plain round on each of d_row_faults' inputs, against the plain
    round on the true ones, falls outside TOLERANCE, while the d values it
    returns move by no more than 0.2 m; check_d_row_faults, which the card
    runs on the CUDA kernel, passes on it."""
    from chip_smoke import (D_ROWS, check_d_row_faults, compare,
                            conditioned_tension_round, d_row_faults)
    args = conditioned_tension_round(16, "cpu")
    want = fused_rounds.structured_round_plain(*args)
    bad = dict(d_row_faults(args))[fault]
    got = fused_rounds.structured_round_plain(*bad)
    assert not compare("fused_structured_round", got, want)["within_tol"]
    moved = float((got[0][:, D_ROWS] - want[0][:, D_ROWS]).abs().max())
    assert 0.0 < moved < 0.2
    check_d_row_faults(args, want)


# ------------------- the sweep order of the K2/K3 kernels -------------------

def kernel_order_solve(Ci, W, b):
    """M x = b in the order the K2/K3 kernels use (csrc/btri_sweep.cuh),
    float32, batch-leading: G_i = Cinv_i W_{i-1} and H_i = Cinv_i^T W_i^T
    once; d = Cinv rhs and e = Cinv^T y in parallel over knots; one matvec
    per sequential step, y_i = d_i - G_i y_{i-1} and x_i = e_i - H_i
    x_{i+1}, each summed as two halves of the row as the kernels sum it."""
    nb = Ci.shape[-1]
    h = nb // 2
    zero = torch.zeros_like(Ci[:, :1])
    G = torch.cat([zero, Ci[:, 1:] @ W], 1)
    H = torch.cat([Ci[:, :-1].transpose(-1, -2) @ W.transpose(-1, -2), zero],
                  1)

    def step(M, d, x):
        lo = torch.einsum("bij,bj->bi", M[..., :h], x[..., :h])
        hi = torch.einsum("bij,bj->bi", M[..., h:], x[..., h:])
        return (d - lo) - hi

    d = torch.einsum("bmij,bmj->bmi", Ci, b)
    m = Ci.shape[1]
    ys, y = [], torch.zeros_like(b[:, 0])
    for i in range(m):
        y = step(G[:, i], d[:, i], y)
        ys.append(y)
    e = torch.einsum("bmji,bmj->bmi", Ci, torch.stack(ys, 1))
    xs, x = [None] * m, torch.zeros_like(b[:, 0])
    for i in range(m - 1, -1, -1):
        x = step(H[:, i], e[:, i], x)
        xs[i] = x
    return torch.stack(xs, 1)


def normal_blocks64(case, rho_bar):
    """Float64 normal blocks (diag (B, m, nb, nb), off (B, m-1, nb, nb)) of
    the test QPs at one rho_bar."""
    if case == "path_nb6":
        qp = chicane_qps([0.8, -0.5, 0.0])
        cls_knot, cls_end = jax.vmap(jassembly.rho_classes)(qp)
        diag, off = jax.vmap(jassembly.normal_blocks,
                             in_axes=(0, 0, 0, None))(
            qp, rho_bar * cls_knot, rho_bar * cls_end, ST.sigma)
        return (torch.as_tensor(np.asarray(diag, np.float64)),
                torch.as_tensor(np.asarray(off, np.float64)))
    from tpu_pathopt_torch.qp import structured
    qp = structured_qp(case)
    rho = rho_bar * np.asarray(jax.vmap(jstructured.rho_classes)(qp),
                               np.float64)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    tqp = structured.BlockBandedQP(
        p_diag=f64(qp.p_diag), p_off=f64(qp.p_off), q=f64(qp.q),
        a_cur=f64(qp.a_cur), a_prev=f64(qp.a_prev), lb=f64(qp.lb),
        ub=f64(qp.ub))
    diag, offp = structured.normal_blocks(tqp, f64(rho), ST.sigma)
    return diag, offp[:, 1:]


def dense_factor_solve64(Ci, W, b):
    """The float64 oracle: x with L L^T x = b, L the dense block-bidiagonal
    factor (C_i = Cinv_i^-1 on the diagonal, W_i below it) that the float32
    factors define, solved densely in float64."""
    B, m, nb, _ = Ci.shape
    out = np.empty(b.shape)
    for k in range(B):
        L = np.zeros((m * nb, m * nb))
        for i in range(m):
            L[i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] = np.linalg.inv(
                Ci[k, i].double().numpy())
            if i:
                L[i * nb:(i + 1) * nb, (i - 1) * nb:i * nb] = \
                    W[k, i - 1].double().numpy()
        out[k] = np.linalg.solve(L @ L.T, b[k].double().numpy().reshape(-1)
                                 ).reshape(m, nb)
    return out


@pytest.mark.parametrize("rho_bar", [1e-6, 0.1, 1e6])
@pytest.mark.parametrize("case", ["path_nb6", "tension2_nb4", "post_nb3",
                                  "tension_nb9"])
def test_kernel_sweep_order_matches_btridiag_and_float64(case, rho_bar):
    """The reassociated sweep of K2/K3 agrees with the JAX package's
    solve_batched and with a float64 oracle at the path-QP shape and both K3
    shapes, across the adaptive-rho clamp. The factors come from a float64
    factorization rounded to float32, so the test holds the sweep's order
    alone: at rho_bar = 1e6 the TENSION2 normal matrix is too ill-conditioned
    for a float32 factorization (K1's concern, not the sweep's), and its
    float32 factors define a visibly different matrix, so the oracle solves
    the system those factors define."""
    diag, off = normal_blocks64(case, rho_bar)
    C, W = btridiag.factor(diag, off)
    Ci, W = btridiag.inv_factors(C, W)
    Ci, W = Ci.float(), W.float()
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.normal(size=Ci.shape[:3]).astype(np.float32))

    got = kernel_order_solve(Ci, W, b)
    assert got.dtype == torch.float32 and got.shape == b.shape
    plain = jbtridiag.solve_batched(jnp.asarray(Ci.numpy()),
                                    jnp.asarray(W.numpy()),
                                    jnp.asarray(b.numpy()))
    assert_close(got, plain, ROUND_TOL)
    assert_close(got, dense_factor_solve64(Ci, W, b), ROUND_TOL)


@pytest.mark.parametrize("case", ["path_nb6", "tension2_nb4", "post_nb3",
                                  "tension_nb9"])
def test_round_in_kernel_sweep_order_matches_pallas_round(case, monkeypatch):
    """A whole 25-iteration round with the K2/K3 kernels' sweep order in
    place of the plain solve stays within the rounds' tolerance of the
    Pallas kernel."""
    monkeypatch.setattr(fused_rounds.btridiag, "solve_batched",
                        kernel_order_solve)
    if case == "path_nb6":
        args, want = k2_case()
        got = fused_rounds.admm_round_plain(*args)
    else:
        args, want = k3_case(case)
        got = fused_rounds.structured_round_plain(*args)
    for a, b in zip(got, want):
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


def lattice(case):
    """random_lattice(seed) for an int case; "ties": chip_smoke's tie-heavy
    lattice at the same small shape, where runs of kp tie exactly and the
    first-index rule decides the parents."""
    if case == "ties":
        from chip_smoke import tie_lattice
        return tie_lattice(5, 9, 11, seed=3)
    return random_lattice(case)


def jax_scan(arrs, w1):
    j = tuple(jnp.asarray(a) for a in arrs)
    return jax.vmap(lambda d, b, h, c0, d0: jcorridor._dp_forward_scan(
        d, b, h, c0, d0, w1))(*j)


@pytest.mark.parametrize("seed", [7, 8, "ties"])
def test_k4_dp_forward_plain_matches_scan_and_pallas(seed):
    w1 = JaxConfig().dp_weight_angle_change
    arrs = lattice(seed)
    scan = jax_scan(arrs, w1)
    pallas = jcorridor._dp_forward_pallas(*(jnp.asarray(a) for a in arrs),
                                          w1, interpret=True)
    got = corridor.dp_forward(*(t(a) for a in arrs), w1)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    assert bool(got[2][:, 3].all()) and not bool(got[2][1, 4:].any())
    for want in (scan, pallas):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def split_first_argmin(total, P):
    """K4's split scan (csrc/dp_forward.cu) on total (B, Kp, K): P slices of
    ceil(Kp / P) parents, each scanned in order with a strict `<` from its
    first kp, then the slices' minima combined in slice order with a strict
    `<`."""
    Kp = total.shape[1]
    size = -(-Kp // P)
    best = best_prev = None
    for kp0 in range(0, Kp, size):
        sb = total[:, kp0]
        sp = torch.full_like(sb, kp0, dtype=torch.int32)
        for kp in range(kp0 + 1, min(Kp, kp0 + size)):
            take = total[:, kp] < sb
            sb = torch.where(take, total[:, kp], sb)
            sp = torch.where(take, kp, sp)
        if best is None:
            best, best_prev = sb, sp
        else:
            take = sb < best
            best = torch.where(take, sb, best)
            best_prev = torch.where(take, sp, best_prev)
    return best, best_prev


@pytest.mark.parametrize("P", [11, 7, 1, 3, 4])
@pytest.mark.parametrize("case", [7, "ties"])
def test_k4_split_scan_matches_plain_and_scan(case, P, monkeypatch):
    """The kernel's P-way split of the kp scan gives the plain version's
    first argmin bit for bit (costs, parents, alive flags), and the JAX
    scan's parents and alive flags, on the random lattice and on the
    tie-heavy one. At K = 11 the launcher takes P = 11 (one kp per slice;
    7 at the main path's K = 35); the others split the 11 unevenly."""
    w1 = JaxConfig().dp_weight_angle_change
    arrs = tuple(t(a) for a in lattice(case))
    want = corridor.dp_forward_plain(*arrs, w1)
    monkeypatch.setattr(corridor, "first_argmin",
                        lambda total: split_first_argmin(total, P))
    got = corridor.dp_forward_plain(*arrs, w1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scan = jax_scan(lattice(case), w1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(scan[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(scan[2]))
    if case == "ties":   # each parent is the first kp of its run of ties
        for b in range(got[1].shape[0]):
            assert bool((got[1][b] % (2 + b % 4) == 0).all())


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


def test_round_kernels_fit_two_blocks_per_sm_and_refuse_what_cannot_fit():
    """K2/K3 run one block per scenario with the round in shared memory: at
    the default config's shapes a block takes at most 110 KB, so two fit
    on an SM and B = 256 runs in one wave on 132 SMs; a shape beyond one
    block's 227 KB or 256 threads raises instead of launching."""
    from tpu_pathopt_torch.config import PlannerConfig
    cfg = PlannerConfig()
    shapes = [("fused_admm_round", cfg.n_knots, 6, 3),
              ("fused_structured_round", cfg.n_segment_points, 4, 3),
              ("fused_structured_round", cfg.dp_layers, 3, 3)]
    for kernel, n, nb, r in shapes:
        smem = fused_rounds.round_smem_bytes(kernel, n, nb, r)
        assert smem <= 110 * 1024, (kernel, n, smem)
        assert fused_rounds.check_round_fits(kernel, n, nb, r) == smem
    # K2 at N = 128: 123 floats per knot and a 48-float reduction tail.
    assert fused_rounds.round_smem_bytes("fused_admm_round", 128) == 63168
    big = fused_rounds.round_smem_bytes("fused_admm_round", 500)
    assert big > fused_rounds.MAX_SMEM_BYTES == 227 * 1024
    with pytest.raises(ValueError, match=f"needs {big} bytes"):
        fused_rounds.check_round_fits("fused_admm_round", 500)
    with pytest.raises(ValueError, match="256 knots"):
        fused_rounds.check_round_fits("fused_structured_round", 257, 4, 3)
    with pytest.raises(ValueError):
        fused_rounds.check_round_fits("fused_admm_round", 0)


def test_round_kernel_takes_the_tension_shape():
    """K3 at the TENSION QP's (9, 9) with N = 22 groups: (2 81 + 18 + 45 +
    2 81) 22 4 = 34,056 bytes of shared memory a block."""
    assert fused_rounds.check_round_fits("fused_structured_round", 22, 9,
                                         9) == 34056


def test_wrapper_shapes_are_the_kernels_instantiations():
    """The block sizes the K1 and K3 wrappers accept on CUDA tensors are
    exactly the templates the C launchers instantiate (any other shape
    raises ValueError in the wrapper before a launch)."""
    import re
    src = (kernels.CSRC / "fused_factor.cu").read_text()
    assert tuple(int(n) for n in re.findall(
        r"case (\d+): return pathopt::launch_factor<\1>", src)) == \
        fused_rounds.FACTOR_NB == (3, 4, 6, 9)
    src = (kernels.CSRC / "fused_structured_round.cu").read_text()
    assert tuple((int(a), int(b)) for a, b in re.findall(
        r"launch_structured<(\d+), (\d+)>\(a, smem", src)) == \
        fused_rounds.ROUND_SHAPES == ((4, 3), (3, 3), (9, 9))


def test_kernel_sources_carry_their_notes():
    """Each .cu file names the TPU kernel it replaces, what bounds it on
    the card and what its design does about that; every source and every
    header is in the build (the headers in its hash)."""
    for name in kernels.SOURCES:
        text = (kernels.CSRC / name).read_text()
        head = text.split("#include")[0]
        assert "Replaces: tpu_pathopt/" in head, name
        assert "What bounds it" in head, name
        assert "What the design does" in head, name
        assert 'extern "C"' in text, name
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == sorted(
        kernels.SOURCES)
    assert sorted(p.name for p in kernels.CSRC.glob("*.cuh")) == sorted(
        kernels.HEADERS)
    assert "-gencode" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
