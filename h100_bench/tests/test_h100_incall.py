"""The readers of the program's in-call spans and node counts
(``metrics/_incall.py``): on a made-up reading each reads its number, on
none each reads nothing; on the card a traced replay of the compiled call
stamps every stage in order and equals the untraced call bit for bit."""

from types import SimpleNamespace

import pytest
import torch

from h100_bench.core import manifest
from h100_bench.metrics import _incall

READING = dict(
    stage_ms=dict(prep=4.1, smooth=1.2, corridor=6.0, post_smooth=2.0,
                  bounds=31.5, path_qp=9.25, finalize=0.8),
    qp_loop_ms=8.5, graph_nodes=33123.5,
    entry_ms=dict(entry=0.61, key=0.05, load=0.2, replay=0.1, clone=0.2))
SMALL = dict(n_knots=24, n_segment_points=16, dp_layers=10,
             bspline_samples=48)
WANT = {"call_stage_ms.bounds": 31.5, "call_stage_ms.path_qp": 9.25,
        "qp_loop_ms": 8.5, "graph_nodes": 33123.5, "entry_host_ms": 0.61}


def reader(name):
    return manifest.module(manifest.HERE / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_its_number(name):
    assert reader(name)({"incall": READING}) == WANT[name]


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_nothing_where_nothing_was_read(name):
    assert reader(name)({"incall": None}) is None
    assert reader(name)({"incall": {}}) is None


def test_the_reading_settles_on_the_windows_fast_level():
    spans = [75.0] * 50 + [62.0] * 50      # the window's two levels
    fast = _incall._fast_ms(spans)
    assert fast == 62.0 and _incall._fast_ms([]) is None
    assert not _incall._at_level([74.9, 75.2, 76.0, 63.1, 75.0], fast)
    assert _incall._at_level([75.0, 75.2, 63.4, 63.0, 63.6], fast)
    assert _incall._at_level([80.0], None)


def test_a_run_with_no_compiled_call_raises_and_a_cpu_run_reads_nothing(
        monkeypatch):
    """A run of a program with tracing that made no compiled call has lost
    its yardstick: the reading raises. Where the run's call was on the CPU
    (the tests' runs) there is nothing to read, and no process is
    started."""
    from tpu_pathopt_torch import pipeline, scenarios
    from tpu_pathopt_torch.config import PlannerConfig
    monkeypatch.setattr(pipeline, "COMPILED", pipeline.SegmentCache())
    with pytest.raises(RuntimeError, match="no compiled call"):
        _incall.value({}, "qp_loop_ms")
    gm, scs, _ = scenarios.build_adversarial(4, device="cpu")
    pipeline.solve_batch_jit(gm, scs, PlannerConfig(**SMALL), device="cpu")
    monkeypatch.setattr(_incall.subprocess, "run", None)
    traced = {}
    assert _incall.value(traced, "qp_loop_ms") is None
    assert traced == {"incall": None}


@pytest.mark.parametrize("argv, want", [
    (["--workload", "default.single", "--seed", "4200000017", "--trace",
      "1"], ("default.single", 4200000017)),
    (["--seed=7", "--seconds", "51", "--workload=default.cold256"],
     ("default.cold256", 7)),
])
def test_the_reading_takes_the_runs_cell_and_seed(argv, want):
    assert _incall.run_args(argv) == want


def test_a_run_without_cell_or_seed_raises():
    with pytest.raises(RuntimeError, match="--workload"):
        _incall.run_args(["--seed", "1"])


def test_a_traced_replay_on_the_card_stamps_every_stage(card):
    from tpu_pathopt_torch import pipeline, profiling, scenarios
    from tpu_pathopt_torch.config import PlannerConfig
    from tpu_pathopt_torch.torchutil import tree_leaves
    gm, scs, _ = scenarios.build_adversarial(8, device=card)
    cfg = PlannerConfig()
    off = pipeline.solve_batch_jit(gm, scs, cfg, device=card)
    with profiling.traced() as tr:
        on = [pipeline.solve_batch_jit(gm, scs, cfg, device=card)
              for _ in range(3)]
    rep = tr.report()
    for res in on:
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(res), tree_leaves(off)))
    for c in rep["calls"]:
        d = c["device"]
        times = [d[n] for n in ("load", *profiling.STAGES, "done", "clone")]
        assert times == sorted(times)
    got = profiling.summarize(rep)
    assert got["calls"] == 2 and got["graph_nodes"] > 0
    assert 0 < got["qp_loop_ms"] < got["replay_ms"]
    clock = next(iter(rep["clock"].values()))
    assert clock["half_width_ns"] < 1e6


class Calls:
    """A driver over a pool of ``pool`` (at most 4) queries, one a call,
    small."""

    def __init__(self, pool):
        from tpu_pathopt_torch import scenarios
        from tpu_pathopt_torch.config import PlannerConfig
        from tpu_pathopt_torch.torchutil import tree_map
        self.gm, scs, _ = scenarios.build_adversarial(4, device="cpu")
        self.cfg = PlannerConfig(**SMALL)
        self.pool = [tree_map(lambda a, k=k: a[k:k + 1], scs)
                     for k in range(pool)]
        self.called = []

    def call(self, i):
        from tpu_pathopt_torch import pipeline
        self.called.append(i)
        pipeline.solve_batch_jit(self.gm, self.pool[i % len(self.pool)],
                                 self.cfg, device="cpu")

    def warm(self):
        self.call(0)

    def forget(self):
        pass


@pytest.fixture
def quick(monkeypatch):
    for name, v in dict(SETTLE=0.0, SETTLE_MAX=0.0, SECONDS=0.0).items():
        monkeypatch.setattr(_incall, name, v)
    return lambda pool: (Calls(pool), SimpleNamespace(
        traffic={"pool": pool}, sync=lambda: None))


def test_the_reading_reads_whole_turns_of_the_pool(quick):
    """On the CPU (stamps on the host clock): warmed up, one call to
    settle, then one whole turn of the pool of three, read."""
    drv, ctx = quick(3)
    got = _incall.read_calls(drv, ctx)
    assert drv.called == [0, 1, 2, 3, 4]
    assert got["calls"] == 3 and got["pool_turns"] == 1
    assert (got["level"], got["attempts"]) == ("fast", 1)
    assert got["stage_ms"]["bounds"] > 0 and got["qp_loop_ms"] > 0
    assert got["entry_ms"]["entry"] > 0 and got["graph_nodes"] is None
    assert not any(got["counts"].values())
    assert len(got["gaps"]) == 3
    assert all(len(label) <= 64 for _, label in got["gaps"])


def test_a_card_that_stays_slow_gives_no_reading(quick):
    """Calls that never reach the fast level are captured again, up to
    ``ATTEMPTS`` times, and then read nothing but the level."""
    drv, ctx = quick(2)
    got = _incall.read_calls(drv, ctx, fast_ms=-1e3)
    assert (got["level"], got["attempts"]) == ("slow", 2)
    assert "stage_ms" not in got and "qp_loop_ms" not in got
    assert drv.called == [0, 1, 0, 2]
