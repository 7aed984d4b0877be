"""The device-side loops of the port's compiled calls on the CPU.

A compiled call runs each QP solve's rounds through ``Segments.loop``, the
counterpart of the JAX package's ``lax.while_loop`` with a ``lax.cond``
around each refactor: on the card a WHILE node and an IF node of the call's
one CUDA graph, here the same loop on the host with one read a round that
stands in for the node's test, the round and refactor counts kept on the
device as the card keeps them.

- The loop itself, on a toy state: as many rounds as the condition asks,
  a refactor after each round that asks for one (the last one too), no
  round where ``start`` is False; the device tallies; the launches counted
  from them at ``sync``; a check carried on the device.
- The launch counts by kernel and key of a compiled call, read once, equal
  the eager path's (here the kernels' wrappers count their plain versions
  as launches, under the key the card's launch has).
- Two input sets of one key whose solves take different numbers of rounds
  each give their eager result and their eager rounds.
- ``max_iter`` 0 runs no round and a ``max_iter`` that cuts active lanes
  stops them where the JAX package's ``while_loop`` does: the port's QP
  solvers through a compiled runner against the JAX package's solvers on
  the same QPs, and the whole compiled call against the eager one.
- Collision rows K2 does not take: the eager path raises before the
  first round; a compiled call converges no lane and raises when its
  checks are read.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import jax_tpu_path
from test_torch_jit import SMALL, guarded, same, small_batch  # noqa: F401
from test_torch_qp import N, path_inputs, smoothing_inputs, t
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt.smoothing.tension2 import build_tension2_structured as jt2
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import path_solver as jpath_solver
from tpu_pathopt_torch import corridor, kernels, pipeline
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import structured
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.smoothing.tension2 import build_tension2_structured
from tpu_pathopt_torch.solver import assembly, fused_rounds, path_solver
from tpu_pathopt_torch.torchutil import SegmentCache, Segments, tree_map

CHECK = QPSettings().check_every


# ------------------------------ the loop itself ------------------------------

@dataclasses.dataclass
class Toy:
    x: torch.Tensor       # () int64: rounds run
    y: torch.Tensor       # () int64: refactors run
    n: torch.Tensor       # () int64: the rounds asked for
    flags: torch.Tensor   # (2,) bool: [run another round, refactor]


def toy_round(run):
    kernels.count_launch("fused_admm_round", "toy")
    x = run.x + 1
    return dataclasses.replace(run, x=x, flags=torch.stack(
        [x < run.n, torch.remainder(x, 3) == 0]))


def toy_refactor(run):
    kernels.count_launch("fused_factor", "toy")
    return dataclasses.replace(run, y=run.y + 1)


def toy_program(drv, n, start):
    kernels.count_launch("dp_forward", "toy")
    run = drv("setup", lambda n: Toy(x=torch.zeros_like(n),
                                     y=torch.zeros_like(n), n=n,
                                     flags=torch.ones(2, dtype=torch.bool)),
              n)
    run, rounds = drv.loop("toy", run, toy_round, toy_refactor, start)
    return run, rounds


@pytest.mark.parametrize("n, start", [(1, True), (3, True), (7, True),
                                      (5, False)])
def test_loop_runs_the_rounds_the_condition_asks(n, start):
    """Eager: ``n`` rounds (none where ``start`` is False), a refactor
    after each round whose x is a multiple of 3, the last round's too;
    rounds a Python int. Compiled: the same state, rounds a device tally;
    the launches stay uncounted until sync, which counts each call's
    launches outside the loop and each body's times the rounds and
    refactors the tallies recorded, over both calls."""
    want_rounds = n if start else 0
    want_refactors = want_rounds // 3
    kernels.reset_launches()
    run, rounds = toy_program(Segments(), torch.tensor(n), start)
    assert rounds == want_rounds and isinstance(rounds, int)
    assert int(run.x) == want_rounds and int(run.y) == want_refactors
    eager = dict(kernels.shape_launches)
    assert eager.get("fused_admm_round[toy]", 0) == want_rounds

    kernels.reset_launches()
    segs = Segments()
    for _ in range(2):
        run, rounds = segs.call(lambda drv, n: toy_program(drv, n, start),
                                (torch.tensor(n),))
        assert isinstance(rounds, torch.Tensor)
        assert int(rounds) == want_rounds
        assert int(run.x) == want_rounds and int(run.y) == want_refactors
    assert kernels.shape_launches == {}
    assert segs.sync() == {"toy": want_rounds}
    assert kernels.shape_launches == {k: 2 * v for k, v in eager.items()}
    kernels.reset_launches()


def check_program(drv, ok):
    drv.check("rows", ok, "bad rows")
    return ok


def test_a_check_is_carried_on_the_device():
    """Segments.check: on the eager path a False flag raises where it is
    checked, a True one never; in a compiled call a False flag raises at
    the first sync after that call and only there, a True one never."""
    Segments().check("rows", torch.tensor(True), "bad rows")
    with pytest.raises(ValueError, match="bad rows"):
        Segments().check("rows", torch.tensor(False), "bad rows")
    segs = Segments()
    segs.call(check_program, (torch.tensor(True),))
    assert segs.sync() == {}
    segs.call(check_program, (torch.tensor(False),))
    segs.call(check_program, (torch.tensor(True),))
    with pytest.raises(ValueError, match="bad rows"):
        segs.sync()
    assert segs.sync() == {}
    segs.call(check_program, (torch.tensor(True),))
    assert segs.sync() == {}
    segs.call(check_program, (torch.tensor(False),))
    with pytest.raises(ValueError, match="bad rows"):
        kernels.sync_counts()
    assert not kernels._pending


@pytest.mark.parametrize("drop", ["reset_launches", "eviction"])
def test_a_failed_check_is_dropped_unread(drop):
    """A failed check that no read of the caller's has raised is dropped,
    not raised, by kernels.reset_launches() and by the cache's eviction of
    its key (inside another key's call), and is gone after them."""
    cache = SegmentCache(maxsize=1)
    segs = cache.get("bad", torch.device("cpu"))
    segs.call(check_program, (torch.tensor(False),))
    assert id(segs) in kernels._pending
    if drop == "reset_launches":
        kernels.reset_launches()
    else:
        other = cache.get("good", torch.device("cpu"))
        assert "bad" not in cache.entries
        other.call(check_program, (torch.tensor(True),))
        kernels.sync_counts()
    assert not kernels._pending
    assert segs.sync() == {}
    kernels.sync_counts()


# ----------------------- the compiled call's counts --------------------------

@pytest.fixture
def counted(monkeypatch):
    """The kernels' wrappers count a launch on the CPU too, where they take
    their plain versions (K5: the geometry stage's plain chain; K6: the
    corridor's refit and lattice nodes; K7: the prep stage's plain chain),
    under the key the card's launch has (c = 1: no cluster at these
    sizes)."""
    def wrap(mod, attr, key):
        fn = getattr(mod, attr)

        def counting(*args, **kw):
            out = fn(*args, **kw)
            kernels.count_launch(attr, key(*args, **kw))
            return out
        monkeypatch.setattr(mod, attr, counting)
    wrap(fused_rounds, "fused_factor", lambda d, o: f"nb={d.shape[1]}")
    wrap(fused_rounds, "fused_admm_round", lambda cc, Ci, *a, **kw:
         f"nb=6,N={Ci.shape[0]},c=1")
    wrap(fused_rounds, "fused_structured_round", lambda Ci, Wp, ac, *a,
         **kw: f"nb={Ci.shape[1]},r={ac.shape[1]},N={Ci.shape[0]},c=1")
    monkeypatch.setattr(corridor, "dp_forward", _count_dp(corridor.dp_forward))
    monkeypatch.setattr(pipeline, "_geometry_plain",
                        _count_geometry(pipeline._geometry_plain))
    monkeypatch.setattr(corridor, "refit_lattice_plain",
                        _count_lattice(corridor.refit_lattice_plain))
    monkeypatch.setattr(pipeline, "_prep_plain",
                        _count_prep(pipeline._prep_plain))
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _count_geometry(fn):
    def counting(gm, scs, xs2, ys2, cor, l_post, config):
        out = fn(gm, scs, xs2, ys2, cor, l_post, config)
        kernels.count_launch("geometry",
                             f"M={l_post.shape[1]},N={config.n_knots}")
        return out
    return counting


def _count_lattice(fn):
    def counting(gm, x, y, n_valid, start_x, start_y, config):
        out = fn(gm, x, y, n_valid, start_x, start_y, config)
        kernels.count_launch("lattice", f"L={config.dp_layers},"
                             f"K={config.dp_laterals}")
        return out
    return counting


def _count_prep(fn):
    def counting(scs, config):
        out = fn(scs, config)
        kernels.count_launch("prep", f"R={scs.raw_x.shape[1]},"
                             f"T={config.bspline_samples},"
                             f"P={config.n_segment_points}")
        return out
    return counting


def _count_dp(fn):
    def counting(dir_all, *args):
        out = fn(dir_all, *args)
        kernels.count_launch("dp_forward", f"K={dir_all.shape[-1]}")
        return out
    return counting


@pytest.mark.parametrize("name", ["default", "rough"])
def test_launch_counts_by_key_equal_eager(name, guarded, counted):
    """A replayed call counts nothing while it runs; read once
    (kernels.sync_counts), its launches by kernel and key equal the eager
    call's."""
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL, **{
        "default": {}, "rough": dict(rough_constraints_far_away=True)}[name])
    pipeline.solve_batch(gm, scs, cfg, device="cpu")
    want = dict(kernels.shape_launches)
    assert set(k.split("[")[0] for k in want) == set(kernels.launches)
    pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    kernels.reset_launches()
    got = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    assert kernels.shape_launches == {}
    kernels.sync_counts()
    assert kernels.shape_launches == want
    assert bool(got.ok.any())


@pytest.fixture
def fresh():
    """The compiled cache emptied before and after."""
    pipeline.COMPILED.clear()
    yield
    pipeline.COMPILED.clear()


def test_two_input_sets_of_one_key(fresh):
    """Two batches of one key, the first two easy and two tight lanes and
    the easy lanes twice over, take different rounds; each compiled call
    equals its eager result and reports its eager rounds."""
    gm, scs = small_batch()
    easy = tree_map(lambda a: a[[0, 1, 0, 1]], scs)
    cfg = PlannerConfig(**SMALL)
    rounds = []
    for batch in (scs, easy, scs):
        want_rounds, got_rounds = {}, {}
        want = pipeline.solve_batch(gm, batch, cfg, device="cpu",
                                    stats=want_rounds)
        got = pipeline.solve_batch_jit(gm, batch, cfg, device="cpu",
                                       stats=got_rounds)
        assert same(got, want)
        assert got_rounds == want_rounds
        rounds.append(want_rounds)
    assert len(pipeline.COMPILED.entries) == 1
    assert rounds[0] != rounds[1] and rounds[0] == rounds[2]


@pytest.mark.parametrize("max_iter", [0, 30])
def test_max_iter_bounds_the_compiled_rounds_as_eager(max_iter, fresh):
    """qp_max_iter 0 runs no round of any QP; 30 (two rounds of 25) stops
    every QP after its second round with lanes still active; the compiled
    call equals the eager one bit for bit, rounds too."""
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL, qp_max_iter=max_iter)
    want_rounds, got_rounds = {}, {}
    want = pipeline.solve_batch(gm, scs, cfg, device="cpu",
                                stats=want_rounds)
    got = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    assert same(got, want)
    pipeline.solve_batch_jit(gm, scs, cfg, device="cpu", stats=got_rounds)
    assert got_rounds == want_rounds
    assert set(want_rounds.values()) <= ({0} if max_iter == 0 else {1, 2})
    if max_iter:
        assert int(want.qp_iters.max()) <= 4 * CHECK
        assert not bool(want.ok.all())


# ---------------------- max_iter against the JAX package ---------------------

def compiled(program, *inputs):
    """``program(drv, *inputs)`` as one compiled call on the CPU."""
    return Segments().call(program, inputs)


def assert_cut_as_jax(got, want, max_iter):
    """Flags equal; no iteration past the round that reached max_iter; an
    unconverged lane stopped at that round, in both packages; converged
    lanes within one check interval of each other."""
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    stop = -(-max_iter // CHECK) * CHECK
    for it in (got.iters.numpy(), np.asarray(want.iters)):
        assert it.max() <= stop
        assert (it[~conv] == stop).all()
    di = np.abs(got.iters.numpy() - np.asarray(want.iters))
    assert di.max() <= CHECK


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("max_iter", [0, 20])
def test_structured_loop_cut_matches_jax(max_iter, fused):
    """The TENSION2 QPs in a compiled runner against the JAX package's
    structured solver: the port's plain rounds against its XLA rounds, and
    K1's and K3's plain versions against its Pallas K1 and K3 (its TPU
    path, in interpret mode). With max_iter 0 both return the start,
    unconverged, at iteration 0; at 20 both stop after the first round (25
    iterations) with the same lanes active and the iterates within the
    5e-3 ``test_torch_qp`` holds the converged solutions to (one algorithm
    in two float orders: the equality rows' large rho make the iterate in
    mid-solve move by up to 2.2e-3 between them)."""
    tq, _ = smoothing_inputs()
    qp_j = jax.vmap(lambda *a: jt2(*a, JaxConfig()))(*tq.values())
    qp = build_tension2_structured(*(t(v) for v in tq.values()),
                                   PlannerConfig())
    st = QPSettings(max_iter=max_iter, fused_rounds=fused)

    def program(drv, qp):
        run = drv("setup", lambda q: structured.structured_setup(
            q, settings=st), qp)
        run, rounds = structured.solve_structured(drv, "qp", run, st)
        return structured.structured_solution(run, rounds)
    got = compiled(program, qp)
    with jax_tpu_path() if fused else contextlib.nullcontext():
        want = jstructured.solve_structured_batched(
            qp_j, settings=JaxSettings(max_iter=max_iter))
        want = jax.tree_util.tree_map(np.asarray, want)
    assert_cut_as_jax(got, want, max_iter)
    assert int(got.rounds) == -(-max_iter // CHECK)
    if max_iter == 0:
        assert not got.converged.any()
        assert not got.v.any() and not want.v.any()
        assert torch.isinf(got.pri_res).all()
    else:
        assert not got.converged.all()
    np.testing.assert_allclose(got.v.numpy(), want.v, atol=5e-3)


@pytest.mark.parametrize("max_iter", [0, 30])
def test_path_loop_cut_matches_jax(max_iter):
    """The path QPs through K2's and K1's plain versions in a compiled
    runner against the JAX package's path solver (its XLA rounds), cold
    from the configured rho as pass 1 runs: the same start at max_iter 0,
    the same cut after the second round at 30 (50 iterations), iterates
    within 1e-4."""
    inp = path_inputs()
    jcfg, cfg = JaxConfig(n_knots=N), PlannerConfig(n_knots=N)
    qp_j = jax.vmap(lambda d: jassembly.assemble_path_qp(
        **d, config=jcfg))(inp)
    qp = assembly.assemble_path_qp(**{k: t(v) for k, v in inp.items()},
                                   config=cfg)
    st = QPSettings(max_iter=max_iter)
    rho0 = st.rho_bar_path

    def program(drv, qp):
        run = drv("setup", lambda q: path_solver.path_setup(
            q, settings=st, rho0=rho0), qp)
        run, rounds = path_solver.solve_path(drv, "qp", run, st)
        return path_solver.path_solution(run, rounds)
    got = compiled(program, qp)
    want = jpath_solver.solve_path_qp_batched(
        qp_j, settings=JaxSettings(max_iter=max_iter),
        rho0=jnp.full((4,), rho0))
    assert_cut_as_jax(got, want, max_iter)
    if max_iter == 0:
        assert not got.v.any() and not np.asarray(want.v).any()
    else:
        assert not got.converged.all()
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-4)


# ------------------------- rows K2 does not take -----------------------------

def test_bad_collision_rows_raise_eager_and_at_the_deferred_read():
    """A kappa term in one collision row: the eager solve raises before
    the first round; the compiled one converges no lane and raises
    when its checks are read (kernels.sync_counts), as on the card, where
    no read is made inside the call."""
    inp = path_inputs()
    qp = assembly.assemble_path_qp(**{k: t(v) for k, v in inp.items()},
                                   config=PlannerConfig(n_knots=N))
    cc = qp.coll_coef.clone()
    cc[1, 3, 0, 2] = 0.5
    bad = dataclasses.replace(qp, coll_coef=cc)
    st = QPSettings(max_iter=100)
    with pytest.raises(ValueError, match="K2 takes collision rows"):
        path_solver.solve_path_qp_batched_eager(bad, settings=st)

    def program(drv, qp):
        run = drv("setup", lambda q: path_solver.path_setup(q, settings=st),
                  qp)
        run, rounds = path_solver.solve_path(drv, "qp", run, st)
        return path_solver.path_solution(run, rounds)
    segs = Segments()
    got = segs.call(program, (bad,))
    assert not got.converged.any()
    assert (got.iters == 100).all()
    with pytest.raises(ValueError, match="K2 takes collision rows"):
        kernels.sync_counts()
    good = segs.call(program, (qp,))
    kernels.sync_counts()
    assert not kernels._pending
    want = path_solver.solve_path_qp_batched_eager(qp, settings=st)
    assert same((good.v, good.converged), (want.v, want.converged))
    assert bool(good.converged.any())
    kernels.reset_launches()
