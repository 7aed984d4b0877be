"""``pipeline.solve_batch_profiled`` on the CPU: each stage a compiled call
of its own (``pipeline.STAGES``), as the JAX package jits each stage of
its ``solve_batch_profiled``.

- The result equals ``solve_batch``'s bit for bit in every field, and the
  QPs' rounds, read from the stage keys' device tallies after the call,
  equal its ``stats``; every stage runs under the capture guard of
  ``test_torch_jit`` (no host read but the loop conditions' stand-ins,
  one a QP round), under the default config, TENSION and A*.
- The recorder's stage names are the JAX package's recorder's on the same
  inputs (``bounds``, not ``geometry``, before the geometry stage).
- A second call reuses every stage key; the stage keys leave the
  compiled pipeline's cache (``pipeline.COMPILED``) as it was.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cli import STAGE_NAMES
from test_torch_fixtures import jax_scenarios
from test_torch_jit import SMALL, VARIANTS, CaptureGuard, same, small_batch
from tpu_pathopt import maps as jmaps
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt import profiling as jprofiling
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import golden, pipeline, profiling, scenarios, \
    torchutil
from tpu_pathopt_torch.config import PlannerConfig

B = 2


@pytest.fixture
def guarded(monkeypatch):
    """Every compiled stage under :class:`CaptureGuard` (after its key's
    warm-up), the stage cache emptied before and after."""
    pipeline.STAGES.clear()
    CaptureGuard.seen = 0
    CaptureGuard.loop_reads = 0
    monkeypatch.setattr(torchutil, "CALL_GUARD", CaptureGuard)
    yield
    pipeline.STAGES.clear()


def profiled(gm, scs, cfg, stats=None):
    rec = profiling.TimeRecorder("pipeline")
    res = pipeline.solve_batch_profiled(gm, scs, cfg, recorder=rec,
                                        device="cpu", stats=stats)
    return res, rec


@pytest.mark.parametrize("name", ["default", "tension", "astar"])
def test_profiled_equals_solve_batch(name, guarded):
    """Bit for bit solve_batch, the same rounds, seven stage keys, and only
    the loop conditions' reads inside the stages."""
    gm, scs = small_batch(B)
    cfg = PlannerConfig(**SMALL, **VARIANTS[name])
    want_stats, got_stats = {}, {}
    want = pipeline.solve_batch(gm, scs, cfg, device="cpu", stats=want_stats)
    CaptureGuard.loop_reads = 0
    got, rec = profiled(gm, scs, cfg, got_stats)
    assert same(got, want)
    assert got_stats == want_stats
    assert CaptureGuard.loop_reads == sum(want_stats.values())
    assert len(pipeline.STAGES.entries) == 7
    assert list(rec.stage_ms()) == list(STAGE_NAMES)


def test_stage_names_are_the_jax_recorders():
    """The port's recorder and the JAX package's, each around its own
    solve_batch_profiled on the same scenarios, name the same stages in
    the same order."""
    arrays = {k: v[:B] for k, v in golden.fixture_arrays("default").items()}
    jgm = jmaps.build_map(jnp.asarray(scenarios.adversarial_mask()),
                          resolution=scenarios.RESOLUTION,
                          pad_shape=scenarios.PAD_SHAPE)
    jrec = jprofiling.TimeRecorder("pipeline")
    jpipe.solve_batch_profiled(jgm, jax_scenarios(arrays), JaxConfig(**SMALL),
                               recorder=jrec)
    gm, scs = golden.fixture_batch("default", "cpu")
    scs = torchutil.tree_map(lambda a: a[:B], scs)
    _, rec = profiled(gm, scs, PlannerConfig(**SMALL))
    assert rec._names == jrec._names
    assert rec._names == list(STAGE_NAMES) + ["done"]


def test_a_second_call_reuses_every_stage_key(guarded):
    """The second call meets the seven keys of the first, the same
    runners, and gives the same result."""
    gm, scs = small_batch(B)
    cfg = PlannerConfig(**SMALL)
    first, _ = profiled(gm, scs, cfg)
    runners = list(pipeline.STAGES.entries.values())
    again, _ = profiled(gm, scs, cfg)
    assert len(pipeline.STAGES.entries) == 7
    assert sorted(map(id, pipeline.STAGES.entries.values())) == \
        sorted(map(id, runners))
    assert same(first, again)
    assert [key[0][0] for key in pipeline.STAGES.entries] == \
        [n for n in STAGE_NAMES]


def test_stage_keys_leave_the_compiled_cache_untouched(guarded):
    """A compiled solve's key stays in ``pipeline.COMPILED``, the same
    runner, through a profiled run; the stages fill only
    ``pipeline.STAGES``."""
    pipeline.COMPILED.clear()
    gm, scs = small_batch(B)
    cfg = PlannerConfig(**SMALL)
    want = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    before = dict(pipeline.COMPILED.entries)
    got, _ = profiled(gm, scs, cfg)
    assert pipeline.COMPILED.entries == before
    assert len(pipeline.STAGES.entries) == 7
    assert same(got, want)
    assert np.all(got.ok.numpy() == want.ok.numpy())
    pipeline.COMPILED.clear()
