"""The reference's second configuration in the port against the JAX
package: the TENSION smoother (``smoothing/tension.py``, the structured QP
at nb = 9, r = 9, through K1 and K3) and the A* corridor search
(``corridor.search_corridor_astar``), stage by stage and end to end against
the fixtures ``jax_tension_b8.npz`` and ``jax_astar_b8.npz``
(``tests/test_torch_fixtures.py`` writes them and says how).

Tolerances: the TENSION QP's blocks to 1e-6 (the same float32 assembly);
the smoothing stage to its termination band, 5e-2 (see the test), held
against the JAX stage's TPU path; the A* corridor as the DP corridor in
``test_torch_stages.py::test_stage_corridor``; end to end
``golden.TOLERANCES`` on the lanes of ``golden.PATH_LANES``.
"""

import dataclasses

import jax
import numpy as np
import pytest

import bench
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.smoothing import tension as jtension
from tpu_pathopt_torch import convert, golden, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.smoothing import tension

from test_torch_fixtures import VARIANTS, jax_tpu_path


def t(a):
    return convert.tensor(np.array(a), "cpu")


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def maxdiff(got, want, mask=None):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(np.where(mask, d, 0).max() if mask is not None else d.max())


@pytest.fixture(scope="module")
def jax_front():
    """The JAX package's prep stage and TENSION2 smoothing stage on the
    golden batch (numpy), the map in both packages and the port's
    scenarios."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    jcfg = JaxConfig()
    prep = jax.jit(jpipe.stage_prep, static_argnames=("config",))(scs, jcfg)
    smooth = jax.jit(jpipe.stage_smooth,
                     static_argnames=("config", "settings"))(
        gm, prep, jcfg, jcfg.qp_settings())
    port_gm = convert.grid_map(dict(esdf=gm.esdf, n_rows=gm.n_rows,
                                    n_cols=gm.n_cols), "cpu")
    return (gm, scs, jax.tree_util.tree_map(np.asarray, (prep, smooth)),
            port_gm, convert.scenario(fields(scs), "cpu"))


def test_build_tension_qp_blocks_matches_jax(jax_front):
    """The block-banded TENSION QP (nb 9, r 9, 22 groups of 3 of the 64
    segment points) equals the JAX package's to 1e-6 on every field."""
    gm, _, (prep, _), port_gm, _ = jax_front
    _, xg, yg, _, ang, _, n_seg = prep
    cfg, jcfg = PlannerConfig(smoothing_method="TENSION"), \
        JaxConfig(smoothing_method="TENSION")
    want = jax.vmap(lambda a, b, c, d: jtension.build_tension_qp_blocks(
        gm, a, b, c, d, jcfg))(xg, yg, ang, n_seg)
    got = tension.build_tension_qp_blocks(port_gm, t(xg), t(yg), t(ang),
                                          t(n_seg), cfg)
    assert (got.nb, got.r) == (9, 9) and got.q.shape == (golden.BATCH, 22, 9)
    for name, w in fields(want).items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)


def test_stage_smooth_tension_matches_jax_tpu_path(jax_front):
    """The TENSION stage against the JAX stage on its TPU path: the Pallas
    factor (nb 9) and round ((9, 9)) kernels in interpret mode, as
    test_torch_stages.py holds post-smoothing.
    Converged flags equal, x/y/s within 5e-2 on valid points: the TENSION
    QP stops after one 25-iteration round, inside its termination band
    eps_abs + eps_rel |A v| of about 0.05 m (|A v| is the 25 m of the
    coordinates), so two float32 runs of the same ADMM may land anywhere in
    it. On this batch the port and the fused path differ by 0.023 m; the
    JAX package's own XLA and fused paths by 0.16 m."""
    gm, _, (prep, _), port_gm, _ = jax_front
    cfg, jcfg = PlannerConfig(smoothing_method="TENSION"), \
        JaxConfig(smoothing_method="TENSION")
    with jax_tpu_path():
        want = jax.tree_util.tree_map(np.asarray, jpipe.stage_smooth(
            gm, tuple(jax.numpy.asarray(a) for a in prep), jcfg,
            jcfg.qp_settings()))
    got = pipeline.stage_smooth(port_gm, tuple(t(a) for a in prep), cfg,
                                cfg.qp_settings())
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert bool(got[4].all())
    m = np.arange(cfg.n_segment_points)[None] < want[3][:, None]
    for i in range(3):
        assert maxdiff(got[i], want[i], m) < 5e-2, i


def test_stage_corridor_astar_matches_jax(jax_front):
    """The A* corridor, fed the JAX TENSION2 stage's output, against the
    JAX A* stage at test_stage_corridor's tolerances: layer counts and
    flags equal, bounds within one 0.2 m march step, 80% of them within
    1e-3."""
    gm, scs, (_, smooth), port_gm, port_scs = jax_front
    cfg, jcfg = PlannerConfig(corridor_method="ASTAR"), \
        JaxConfig(corridor_method="ASTAR")
    _, _, cor_j = jax.jit(jpipe.stage_corridor,
                          static_argnames=("config",))(gm, scs, smooth, jcfg)
    _, _, cor = pipeline.stage_corridor(port_gm, port_scs,
                                        tuple(t(a) for a in smooth), cfg)
    want, got = fields(cor_j), fields(cor)
    for name in ("n_layers", "ok"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert maxdiff(got["layers_s"], want["layers_s"]) < 1e-3
    assert maxdiff(got["vehicle_l"], want["vehicle_l"]) < 1e-4
    m = np.arange(cfg.dp_layers)[None] < want["n_layers"][:, None]
    for name in ("lower", "upper"):
        d = np.abs(got[name] - want[name])[m]
        assert d.max() < 0.2 + 1e-3, name
        assert np.mean(d < 1e-3) >= 0.8, name


def test_one_scenario_entry_points_are_batches_of_one(jax_front):
    """tension_smooth is a row of tension_smooth_batched, and
    search_corridor (lattice, K4's plain version on CPU tensors, finish) is
    the DP stage's corridor."""
    from tpu_pathopt_torch import corridor, splines
    gm, _, (prep, smooth), port_gm, port_scs = jax_front
    _, xg, yg, _, ang, _, n_seg = prep
    cfg = PlannerConfig(smoothing_method="TENSION")
    batch = tension.tension_smooth_batched(port_gm, t(xg), t(yg), t(ang),
                                           t(n_seg), cfg)
    one = tension.tension_smooth(port_gm, t(xg[3]), t(yg[3]), t(ang[3]),
                                 int(n_seg[3]), cfg)
    for a, b in zip(one, batch):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b[3]),
                                   atol=1e-5)
    xs2, ys2, cor = pipeline.stage_corridor(
        port_gm, port_scs, tuple(t(a) for a in smooth), PlannerConfig())
    got = corridor.search_corridor(
        port_gm, xs2, ys2, splines.refit(*(t(a) for a in (
            smooth[0], smooth[1], smooth[3])))[2] + 3.0, port_scs.start_x,
        port_scs.start_y, port_scs.start_heading, PlannerConfig())
    for name, w in fields(cor).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), w, name)


@pytest.mark.parametrize("name", VARIANTS)
def test_port_matches_variant_fixture_on_cpu(name):
    """The port on the CPU against the JAX package's stored result: flags
    equal, counts within golden's limits, paths within the fixture's
    tolerances (golden.compare_fixture) on the lanes of golden.PATH_LANES."""
    want = golden.load(golden.FIXTURES[name])
    assert bool(want["ok"].all())
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    res = pipeline.solve_batch(gm, scs, PlannerConfig(**golden.CONFIGS[name]),
                               device="cpu")
    failures, diffs = golden.compare_fixture(name, golden.arrays(res), want)
    assert not failures, (failures, diffs)


def test_collision_and_diagnostics_match_jax(jax_front):
    """collision.py and diagnostics.py against the JAX package's on the
    TENSION fixture's paths: the footprint circles to 1e-6, the state
    checks equal, the free share equal, the oriented box to 1e-5 and the
    bounds dump the same text."""
    import types

    from tpu_pathopt import collision as jcollision
    from tpu_pathopt import diagnostics as jdiagnostics
    from tpu_pathopt_torch import collision, diagnostics
    gm, _, _, port_gm, _ = jax_front
    d = golden.load(golden.FIXTURES["tension"])
    cfg, jcfg = PlannerConfig(), JaxConfig()
    car_j = jcollision.make_car_geometry(jcfg)
    car = collision.make_car_geometry(cfg, "cpu")
    for name, w in fields(car_j).items():
        np.testing.assert_allclose(getattr(car, name).numpy(), w, atol=1e-6)
    # The paths, and the same paths moved 1.5 m sideways into the walls.
    for dy in (0.0, 1.5):
        x, y, h = d["x"], d["y"] + dy, d["heading"]
        want = jcollision.is_state_collision_free_improved(gm, car_j, x, y, h)
        got = collision.is_state_collision_free_improved(
            port_gm, car, t(x), t(y), t(h))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    res = convert.path_result(
        {**{k: v for k, v in d.items() if "." not in k},
         "bounds": {k.split(".")[1]: v for k, v in d.items()
                    if k.startswith("bounds.")}}, "cpu")
    res_j = types.SimpleNamespace(
        **{k: v for k, v in d.items() if "." not in k},
        bounds=types.SimpleNamespace(**fields(res.bounds)))
    res_j.mask = np.arange(d["x"].shape[1])[None] < d["n_valid"][:, None]
    assert float(collision.path_collision_free(port_gm, car, res)) == \
        pytest.approx(float(jcollision.path_collision_free(gm, car_j, res_j)))
    assert diagnostics.dump_bounds(res, 6, max_rows=40) == \
        jdiagnostics.dump_bounds(res_j, 6, max_rows=40)
    box_j = jcollision.make_box(1.0, -2.0, 0.4, 4.0, 1.8, is_left=True)
    box = collision.make_box(1.0, -2.0, 0.4, 4.0, 1.8, is_left=True,
                             device="cpu")
    pts = np.random.default_rng(0).uniform(-6, 6, (2, 50)).astype(np.float32)
    np.testing.assert_allclose(
        collision.box_distance_to(box, t(pts[0]), t(pts[1])).numpy(),
        np.asarray(jcollision.box_distance_to(box_j, pts[0], pts[1])),
        atol=1e-5)
    for g, w in zip(collision.box_by_circles(box),
                    jcollision.box_by_circles(box_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert int(box.dir) == int(box_j.dir) == jcollision.BOX_DIR_LEFT
