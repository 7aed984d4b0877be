"""The port's seven standalone QP solvers as compiled calls on the CPU: the
counterparts of the JAX package's jitted ``admm.solve_qp``,
``solve_qp_batched`` and ``trace_rounds``, ``structured.
solve_structured_batched``, and ``path_solver.solve_path_qp``,
``trace_path_rounds`` and ``solve_path_qp_batched``.

Each runs through ``torchutil.compiled`` (its own cache,
``torchutil.SOLVERS``): here the program on every call, each loop on the
host with one read a round that stands in for the condition a conditional
graph node tests on the card. Under the ``guarded`` mode of
``test_torch_jit`` (which refuses any other read, a tensor made from host
data, or a shape the data decides):

- compiled equals its ``<name>_eager`` twin bit for bit in every field,
  cold, warm-started (``x0``/``y0``/``rho0`` given) and cut by
  ``max_iter``; its rounds (a device tally) equal the eager rounds;
- the host reads in a call are the loop condition's stand-ins and nothing
  else: one a round;
- a given and an omitted start are separate keys, and a second call
  reuses its key;
- a trace has ``n_rounds`` rows and runs exactly ``n_rounds`` rounds: 4,
  1, and more than every lane needs to converge (the rows after it
  frozen).

Against the JAX package's jitted solvers on the same QPs, at the
tolerances the port's tests of each solver already hold: the dense
solvers in float64 within 1e-9 with the same iterations
(``test_torch_dense_qp``), the dense trace the same, the block-banded and
path solvers with the same flags, iterations within one check interval
and the solution within 5e-3 (``test_torch_qp``, ``test_torch_cli``), the
path trace as ``test_torch_cli`` holds it. The dense batched solver's
refactor takes the JAX package's form (every lane factored under the
round's gate, kept where rho changed): a case where rho adapts on some
lanes and not others holds it to the JAX solver.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_qp import _random_qp
from test_torch_cli import path_qps
from test_torch_dense_qp import TIGHT, assert_same_float64, jax64, t64
from test_torch_jit import CaptureGuard
from test_torch_qp import CHECK, smoothing_inputs, t
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp import admm as jadmm
from tpu_pathopt.qp import structured as jstructured
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt.smoothing.tension2 import build_tension2_structured as jt2
from tpu_pathopt.solver import path_solver as jpath_solver
from tpu_pathopt_torch import torchutil
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, structured
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.smoothing.tension2 import build_tension2_structured
from tpu_pathopt_torch.solver import path_solver

SOLVER_NAMES = ("solve_qp", "solve_qp_batched", "trace_rounds",
                "solve_structured_batched", "solve_path_qp",
                "trace_path_rounds", "solve_path_qp_batched")
TRACE_ROUNDS = 4
CUT = 30      # max_iter of the cut variant: two rounds of 25
# The traces' other lengths: one round, and past every lane's convergence
# (the dense QP converges in 2 rounds, the path QPs in 6).
TRACE_LENGTHS = {"one": 1, "past": 8}
CASES = ([(name, variant) for variant in ("cold", "warm", "cut")
          for name in SOLVER_NAMES]
         + [(name, variant) for name in ("trace_rounds", "trace_path_rounds")
            for variant in TRACE_LENGTHS])


@pytest.fixture
def guarded(monkeypatch):
    """Every compiled call under :class:`CaptureGuard` (after its key's
    warm-up), the solver cache emptied before and after."""
    torchutil.SOLVERS.clear()
    CaptureGuard.seen = 0
    CaptureGuard.loop_reads = 0
    monkeypatch.setattr(torchutil, "CALL_GUARD", CaptureGuard)
    yield
    torchutil.SOLVERS.clear()


def dense_inputs(batch=None, seed=0):
    """test_qp's random QPs at a small size in float64, one or a batch."""
    rng = np.random.default_rng(seed)
    probs = [_random_qp(rng, nv=12, nc=16, n_eq=4)
             for _ in range(batch or 1)]
    qp = t64(*(np.stack([p[i] for p in probs]) for i in range(5)))
    return qp if batch else tuple(a[0] for a in qp)


def tension2_qp():
    tq, _ = smoothing_inputs()
    return build_tension2_structured(*(t(v) for v in tq.values()),
                                     PlannerConfig())


def case(name, variant):
    """(compiled, eager, args, kwargs) of one solver in
    one variant: "cold", "warm" (a start given) or "cut" (max_iter cut);
    a trace also "one" and "past" (cold, of :data:`TRACE_LENGTHS`
    rounds)."""
    rng = np.random.default_rng(5)
    st = QPSettings(max_iter=CUT) if variant == "cut" else QPSettings()
    kw = dict(settings=st)
    warm = variant == "warm"

    def rand(shape, dtype):
        return torch.as_tensor(0.1 * rng.normal(size=shape), dtype=dtype)

    if name in ("solve_qp", "solve_qp_batched", "trace_rounds"):
        P, q, A, l, u = dense_inputs(3 if name == "solve_qp_batched"
                                     else None)
        args = (P, q, A, l, u)
        if warm:
            kw.update(x0=rand(q.shape, q.dtype),
                      y0=rand(l.shape, l.dtype))
        if name == "trace_rounds":
            kw["n_rounds"] = TRACE_LENGTHS.get(variant, TRACE_ROUNDS)
    elif name == "solve_structured_batched":
        qp = tension2_qp()
        args = (qp,)
        if warm:
            kw.update(v0=rand(qp.q.shape, qp.q.dtype),
                      y0=rand(qp.lb.shape, qp.lb.dtype))
    else:
        qp = path_qps(np.float32)[1]
        args = (qp,)
        if warm:
            B, N = qp.p_diag.shape[:2]
            kw.update(v0=rand((B, N, 6), torch.float32),
                      y0_knot=rand((B, N, 6), torch.float32),
                      y0_end=rand((B, 2), torch.float32),
                      rho0=torch.full((B,), 0.3))
        elif variant != "cut":
            kw["rho0"] = 0.1      # a number: a 0-d tensor of the key
        if name == "trace_path_rounds":
            kw["n_rounds"] = TRACE_LENGTHS.get(variant, TRACE_ROUNDS)
    mod = {"solve_qp": admm, "solve_qp_batched": admm, "trace_rounds": admm,
           "solve_structured_batched": structured}.get(name, path_solver)
    return (getattr(mod, name), getattr(mod, name + "_eager"), args, kw)


def same(a, b):
    """Every tensor of two results equal bit for bit (NaN where NaN), with
    the same dtype and shape, float64 and 0-d tensors included."""
    la, lb = torchutil.tree_leaves(a), torchutil.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype.is_floating_point:
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                x.element_size()]
            x, y = x.reshape(-1).view(bits), y.reshape(-1).view(bits)
        assert torch.equal(x, y)
    return True


def strip(sol):
    """A solution without its rounds (an int eager, a device tensor
    compiled), or a trace as it is."""
    return (dataclasses.replace(sol, rounds=0)
            if dataclasses.is_dataclass(sol) else sol)


def rounds_run(name, out, kw):
    """The rounds a call ran: a trace's ``n_rounds``, a solve's count."""
    return kw["n_rounds"] if name.startswith("trace") else int(out.rounds)


@pytest.mark.parametrize("name, variant", CASES)
def test_compiled_equals_eager(name, variant, guarded):
    """Bit for bit the eager twin in every field, its rounds, one key, and
    only the condition's reads inside the call, one a round."""
    fn, eager, args, kw = case(name, variant)
    want = eager(*args, **kw)
    CaptureGuard.loop_reads = 0
    got = fn(*args, **kw)
    assert CaptureGuard.seen > 0
    assert CaptureGuard.loop_reads == rounds_run(name, got, kw)
    assert len(torchutil.SOLVERS.entries) == 1
    assert same(strip(got), strip(want))
    if dataclasses.is_dataclass(got):
        assert isinstance(got.rounds, torch.Tensor)
        assert int(got.rounds) == want.rounds
        if variant == "cut":
            assert int(got.iters.max()) <= -(-CUT // CHECK) * CHECK
    else:
        assert all(v.shape[0] == kw["n_rounds"] for v in got.values())
        if variant == "past" and name == "trace_path_rounds":
            assert bool(got["converged"][-2].all())
        elif variant == "past":
            assert torch.equal(got["x"][-1], got["x"][-2])
    segs = next(iter(torchutil.SOLVERS.entries.values()))
    assert segs.sync() == {"qp": rounds_run(name, want, kw)}


@pytest.mark.parametrize("name", ["solve_qp", "solve_qp_batched",
                                  "solve_structured_batched",
                                  "solve_path_qp", "solve_path_qp_batched"])
def test_given_and_omitted_starts_are_separate_keys(name, guarded):
    """A cold and a warm-started call are two keys; a second cold call
    reuses its key and gives its result again."""
    fn, _, args, cold_kw = case(name, "cold")
    _, _, _, warm_kw = case(name, "warm")
    first = fn(*args, **cold_kw)
    fn(*args, **warm_kw)
    again = fn(*args, **cold_kw)
    assert len(torchutil.SOLVERS.entries) == 2
    assert same(strip(first), strip(again))


def test_dense_batched_refactor_in_the_jax_form(guarded):
    """At eps 1e-6 rho adapts on some lanes and not on others in the same
    round: the refactor (every lane factored, the new factor kept where
    rho changed) runs, compiled equals eager, and both equal the JAX
    package's solve_qp_batched in float64 (1e-9, the same iterations)."""
    P, q, A, l, u = dense_inputs(4, seed=7)
    st = QPSettings(**TIGHT)
    want = admm.solve_qp_batched_eager(P, q, A, l, u, settings=st)
    got = admm.solve_qp_batched(P, q, A, l, u, settings=st)
    assert same(strip(got), strip(want))
    segs = next(iter(torchutil.SOLVERS.entries.values()))
    refactors = int(segs.loops["qp"][1])
    assert 0 < refactors < int(got.rounds)
    jax_sol = jax64(jadmm.solve_qp_batched, *(a.numpy() for a in
                                              (P, q, A, l, u)),
                    settings=JaxSettings(**TIGHT))
    assert_same_float64(got, jax_sol)
    assert bool(got.converged.all())


@pytest.mark.parametrize("name", ["solve_qp", "solve_qp_batched"])
def test_dense_solvers_match_jax(name, guarded):
    """The compiled dense solvers in float64 against the JAX package's
    jitted ones: x, y and z within 1e-9, the same iterations and flags."""
    batch = 3 if name == "solve_qp_batched" else None
    qp = dense_inputs(batch)
    got = getattr(admm, name)(*qp)
    want = jax64(getattr(jadmm, name), *(a.numpy() for a in qp))
    assert_same_float64(got, want)
    assert bool(got.converged.all())


def test_dense_trace_matches_jax(guarded):
    """The compiled trace in float64 against the JAX package's jitted
    trace_rounds: every round within 1e-9 (the float64 solver's bound), the
    same rho_bar at every round."""
    qp = dense_inputs()
    got = admm.trace_rounds(*qp, n_rounds=TRACE_ROUNDS)
    with jax.enable_x64(True):
        want = jadmm.trace_rounds(*(jax.numpy.asarray(a.numpy())
                                    for a in qp), n_rounds=TRACE_ROUNDS)
        want = {k: np.asarray(v) for k, v in want.items()}
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=k)


def test_structured_matches_jax(guarded):
    """The compiled block-banded solver (K1's and K3's plain versions)
    against the JAX package's: the same flags, iterations within one check
    interval, v within 5e-3 (``test_torch_qp``)."""
    tq, _ = smoothing_inputs()
    qp_j = jax.vmap(lambda *a: jt2(*a, JaxConfig()))(*tq.values())
    want = jstructured.solve_structured_batched(qp_j, settings=JaxSettings())
    got = structured.solve_structured_batched(tension2_qp())
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= CHECK
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=5e-3)


@pytest.mark.parametrize("name", ["solve_path_qp", "solve_path_qp_batched"])
def test_path_solvers_match_jax(name, guarded):
    """The compiled path solvers, cold from rho 0.1 as pass 1 runs, against
    the JAX package's (the scalar one vmapped): the same flags, iterations
    within one check interval, v within 5e-3."""
    qp_j, qp = path_qps(np.float32)
    if name == "solve_path_qp":
        want = jax.vmap(lambda q: jpath_solver.solve_path_qp(
            q, settings=JaxSettings(), rho0=0.1))(qp_j)
    else:
        want = jpath_solver.solve_path_qp_batched(
            qp_j, settings=JaxSettings(), rho0=jax.numpy.full((4,), 0.1))
    got = getattr(path_solver, name)(qp, rho0=0.1)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= CHECK
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=5e-3)


def test_path_trace_matches_jax(guarded):
    """The compiled path trace in float64 against the JAX package's, as
    ``test_torch_cli`` holds the eager one: the same iterations and flags,
    rho_bar within 5e-3 relative, ``n_rounds`` rows of the batch."""
    with jax.enable_x64(True):
        qp_j, qp = path_qps(np.float64)
        want = jax.vmap(lambda q: jpath_solver.trace_path_rounds(
            q, JaxSettings(), n_rounds=TRACE_ROUNDS, rho0=0.1))(qp_j)
        want = {k: np.asarray(v).T for k, v in want.items()}
    got = {k: v.numpy() for k, v in path_solver.trace_path_rounds(
        qp, QPSettings(), n_rounds=TRACE_ROUNDS, rho0=0.1).items()}
    assert got["iters"].shape == (TRACE_ROUNDS, 4)
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["rho_bar"], want["rho_bar"], rtol=5e-3)
