"""The port's compiled entry points (``pipeline.solve_batch_jit``,
``solve_jit``, the compiled ``replan.replan_step``) on the CPU, where they
run the same runner as on the card without capture
(``torchutil.Segments``): the whole stage chain on every call, each QP
round ending in one read that stands in for the condition a conditional
graph node tests on the card.

- Equal to eager, bit for bit: every field of the result (bounds included)
  under the default config, TENSION + DP, TENSION2 + A*, the rough rows and
  the prescan fallback, a warm start, and 3 replanning cycles.
- Equal to the JAX package: the compiled results on the golden batch
  against the JAX fixtures at ``golden.TOLERANCES`` (``golden.py``).
- A later call at the same key leaves a returned result as it was; a
  second call at the same key reuses its entry, a new batch size or config
  makes a new one.
- The pin that a call can be captured as one graph: the whole compiled
  call of every configuration above runs under a dispatch mode that
  refuses a host read (``aten._local_scalar_dense``), a tensor made from
  host data (``aten.lift_fresh``) and an operation whose result's shape
  depends on the data (``nonzero``, a boolean index), the operations a
  CUDA graph cannot hold, except the loop conditions' reads, one a QP
  round: as many as the eager path's rounds, which the device's round
  counters equal. The same mode over the eager path catches its round
  read.

The bit-for-bit and capture tests run at a small config (``SMALL``) on
four scenarios, the fixture tests at the fixtures' own configs.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pathopt_torch import golden, pipeline, replan, scenarios, torchutil
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_leaves, tree_map

SMALL = dict(n_knots=24, n_segment_points=16, dp_layers=10,
             bspline_samples=48)
VARIANTS = {"default": {}, "tension": dict(smoothing_method="TENSION"),
            "astar": dict(corridor_method="ASTAR"),
            "rough": dict(rough_constraints_far_away=True),
            "prescan": dict(directional_prescan_fallback=True)}
FIXTURE_NAMES = ("default", "tension", "astar", "rough")
B = 4

aten = torch.ops.aten
# What a captured segment cannot hold: a read to the host, a tensor made
# from host data, a result whose shape the data decides.
REFUSED = {aten._local_scalar_dense.default, aten.lift_fresh.default,
           aten.nonzero.default, aten.masked_select.default,
           aten.equal.default}


class HostRead(AssertionError):
    pass


class CaptureGuard(TorchDispatchMode):
    """Refuses the operations a CUDA graph cannot hold (except the reads
    ``torchutil.plain_read`` marks: those of a kernel's plain version,
    which never runs on the card, and the loop conditions' reads
    ``torchutil.loop_read`` marks, which it counts); counts the operations
    it let through.

    One tensor made from host data is legal: ``t[...] = 0.0`` wraps the
    number in a 0-d CPU tensor, takes the view and fills it with the number
    (``aten.fill_.Tensor``), which reads it on the host, not the device.
    Any other use of such a tensor is refused."""

    seen = 0
    loop_reads = 0

    def __init__(self):
        super().__init__()
        self.number = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.number is not None and not func.is_view:
            number, self.number = self.number, None
            if not (func is aten.fill_.Tensor and args[1] is number):
                raise HostRead(f"a tensor made from host data reaches {func}")
        bool_index = func is aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        fill_value = func is aten.lift_fresh.default and args[0].dim() == 0
        if ((func in REFUSED and not fill_value) or bool_index) \
                and not torchutil.in_plain_read():
            if not (torchutil.in_loop_read()
                    and func is aten._local_scalar_dense.default):
                raise HostRead(f"{func} inside a compiled call")
            CaptureGuard.loop_reads += 1
        CaptureGuard.seen += 1
        out = func(*args, **(kwargs or {}))
        if fill_value:
            self.number = out
        return out


@pytest.fixture
def guarded(monkeypatch):
    """Every compiled call run under :class:`CaptureGuard` (after its key's
    warm-up, as a capture follows one), with the compiled cache emptied
    first so every key is met anew."""
    pipeline.COMPILED.clear()
    CaptureGuard.seen = 0
    CaptureGuard.loop_reads = 0
    monkeypatch.setattr(torchutil, "CALL_GUARD", CaptureGuard)
    yield
    pipeline.COMPILED.clear()


def same(a, b):
    """Every tensor of two results equal bit for bit (NaN where NaN), with
    the same dtype and shape."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype.is_floating_point:
            x, y = x.contiguous().view(torch.int32), \
                y.contiguous().view(torch.int32)
        assert torch.equal(x, y)
    return True


def small_batch(n=B):
    gm, scs = golden.fixture_batch("default", "cpu")
    return gm, tree_map(lambda a: a[:n], scs)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_compiled_equals_eager_and_segments_capture(name, guarded):
    """solve_batch_jit equals solve_batch bit for bit in every field; the
    whole call runs under the capture guard, whose only host reads are the
    loop conditions', one a round of each QP; the device's round counters
    equal the eager rounds."""
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL, **VARIANTS[name])
    rounds, counted = {}, {}
    want = pipeline.solve_batch(gm, scs, cfg, device="cpu", stats=rounds)
    got = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu", stats=counted)
    assert same(got, want)
    assert CaptureGuard.seen > 1000
    assert CaptureGuard.loop_reads == sum(rounds.values())
    assert counted == rounds
    assert bool(got.ok.any())


def test_warm_start_and_replan_cycles_equal_eager(guarded):
    """3 cycles of the compiled replan_step (a warm start from the second
    on, the advance inside the compiled call) equal the eager cycles bit
    for bit, result, warm state and advanced poses; under the guard."""
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL)
    warm_e = warm_c = pipeline.QPWarmStart.cold(B, cfg, "cpu")
    scs_e = scs_c = scs
    for _ in range(3):
        want = replan.replan_step_eager(gm, scs_e, warm_e, cfg, None, 1.0,
                                        device="cpu")
        got = replan.replan_step(gm, scs_c, warm_c, cfg, None, 1.0,
                                 device="cpu")
        assert same(got, want)
        _, warm_e, scs_e = want
        _, warm_c, scs_c = got
    assert bool(warm_c.valid.any())


def test_eager_loop_read_is_caught():
    """The guard bites: over the eager path (run once before, so its
    constants are built, as a capture's warm-up builds them) it stops at
    the first round's host read."""
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL)
    pipeline.solve_batch(gm, scs, cfg, device="cpu")
    with pytest.raises(HostRead, match="_local_scalar_dense"):
        with CaptureGuard():
            pipeline.solve_batch(gm, scs, cfg, device="cpu")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_compiled_matches_jax_fixture(name):
    """The compiled solve of the golden batch against the JAX package's
    fixture, at golden.py's tolerances."""
    gm, scs = golden.fixture_batch(name, "cpu")
    cfg = PlannerConfig(**golden.CONFIGS[name])
    got = golden.arrays(pipeline.solve_batch_jit(gm, scs, cfg, device="cpu"))
    failures, diffs = golden.compare_fixture(
        name, got, golden.load(golden.FIXTURES[name]))
    assert not failures, (failures, diffs)


def test_compiled_replan_stream_matches_jax_fixture():
    """golden.REPLAN_CYCLES cycles of the compiled replan_step, as
    replan_stream drives it, against the JAX package's replan fixture."""
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    cfg = PlannerConfig(**golden.CONFIGS["replan"])
    got = golden.replan_arrays(
        lambda s, w: replan.replan_step(gm, s, w, cfg, None,
                                        golden.REPLAN_DS, device="cpu"),
        scs, pipeline.QPWarmStart.cold(golden.BATCH, cfg, "cpu"))
    failures, diffs = golden.compare_fixture(
        "replan", got, golden.load(golden.FIXTURES["replan"]))
    assert not failures, (failures, diffs)


def test_results_survive_later_calls_and_the_cache_is_keyed():
    """A second call at the same key with other inputs reuses the entry
    and leaves the first result unchanged (the static buffers are
    refilled, the result was cloned out); a new batch size and a new
    config each make a new entry; solve_jit is the batch of one."""
    pipeline.COMPILED.clear()
    gm, scs = small_batch()
    cfg = PlannerConfig(**SMALL)
    first = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    kept = tree_map(torch.clone, first)
    assert len(pipeline.COMPILED.entries) == 1
    moved = dataclasses.replace(scs, start_y=scs.start_y + 0.25)
    second = pipeline.solve_batch_jit(gm, moved, cfg, device="cpu")
    assert len(pipeline.COMPILED.entries) == 1
    assert same(first, kept)
    assert not torch.equal(second.y, first.y)
    assert same(second, pipeline.solve_batch(gm, moved, cfg, device="cpu"))
    pipeline.solve_batch_jit(gm, tree_map(lambda a: a[:2], scs), cfg,
                             device="cpu")
    assert len(pipeline.COMPILED.entries) == 2
    pipeline.solve_batch_jit(gm, scs, dataclasses.replace(
        cfg, corridor_method="ASTAR"), device="cpu")
    assert len(pipeline.COMPILED.entries) == 3
    sc = tree_map(lambda a: a[0], scs)
    one = pipeline.solve_jit(gm, sc, cfg, device="cpu")
    assert one.x.shape == (cfg.n_knots,)
    assert same(one, pipeline.solve(gm, sc, cfg, device="cpu"))
    assert len(pipeline.COMPILED.entries) == 4
    pipeline.COMPILED.clear()


def test_compiled_entry_points_need_a_device_or_the_card():
    """As every entry point: with no device given they run on CUDA, and
    raise where there is none (a compiled call never falls back)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gm, scs = small_batch(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.solve_batch_jit(gm, scs, PlannerConfig(**SMALL))


def test_segments_refuse_other_tensors_and_aliased_results():
    """The runner's own checks, on the CPU: a result copied into two
    destinations that share memory, or aliasing the destination it is
    copied into, raises."""
    segs = torchutil.Segments()
    a = torch.zeros(4)
    with pytest.raises(RuntimeError, match="share memory"):
        segs("s", lambda x: (x + 1, x + 2), a, into=(a, a))
    b = torch.zeros(4)
    with pytest.raises(RuntimeError, match="aliases"):
        segs("t", lambda x, y: (y[:], x + 1), a, b, into=(a, b))
    out = segs("u", lambda x: (x + 1, x), a, into=(b, a))
    assert out[0] is b and torch.equal(b, torch.ones(4))
    assert torchutil.host_flags(torch.tensor([True, False, True])) == \
        [True, False, True]
    assert torchutil.signature(a) == ("T", (4,), torch.float32)
