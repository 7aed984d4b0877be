"""Tracing inside the port's compiled call (``profiling.traced``), on the
CPU, where the traced key runs the program on every call and each stamp is
``time.perf_counter_ns()`` at the point the card's graph stamps.

- Off, a compiled call is the untraced one: the eager path's results bit
  for bit, the untraced key, no span; on, a second key whose results equal
  it bit for bit.
- The seven stage spans are in order inside the call's ``entry`` span; the
  four QP loops lie inside their stages and carry the eager path's rounds.
- The corridor stage's parts (the DP search's edge costs, K4, the finish)
  lie in order inside it, and the call's key notes the lattice's work.
- The accounting of executed graph nodes, the naming of idle gaps and the
  set-up counts, on made-up inputs and a one-segment program; the
  summary's corridor parts and QP loops on a made-up report, with and
  without the corridor's stamps.
- On the card (marked ``card``; skipped without a CUDA device): the
  untraced key's graph holds no stamp, node for node the traced key's
  less its stamps. Run it there with ``python3 -m pytest
  tests/test_torch_tracing.py -m card --noconftest -o addopts=""``.
"""

import contextlib
import gc
from types import SimpleNamespace

import pytest
import torch

from tpu_pathopt_torch import pipeline, profiling, scenarios, torchutil
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_leaves

SMALL = dict(n_knots=24, n_segment_points=16, dp_layers=10,
             bspline_samples=48)
B = 4
LOOPS = {"smooth": "smooth", "post": "post_smooth", "qp1": "path_qp",
         "qp2": "path_qp"}


def equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def last_setup_span():
    return profiling.SETUP[-1] if profiling.SETUP else None


@pytest.fixture(scope="module")
def runs():
    gm, scs, _ = scenarios.build_adversarial(B, device="cpu")
    cfg = PlannerConfig(**SMALL)
    pipeline.COMPILED.clear()
    stats = {}
    eager = pipeline.solve_batch(gm, scs, cfg, device="cpu", stats=stats)
    setup0 = last_setup_span()
    off = pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
    off_entries = dict(pipeline.COMPILED.entries)
    setup_off = last_setup_span() is not setup0
    with profiling.traced() as tr:
        on = [pipeline.solve_batch_jit(gm, scs, cfg, device="cpu")
              for _ in range(2)]
    last = {traced: pipeline.last_compiled(traced)
            for traced in (False, True)}
    return SimpleNamespace(eager=eager, stats=stats, off=off, on=on,
                           off_entries=off_entries, setup_off=setup_off,
                           rep=tr.report(), last=last, cfg=cfg,
                           entries=dict(pipeline.COMPILED.entries))


def test_tracing_off_is_the_untraced_call(runs):
    assert profiling.ACTIVE is None
    assert equal(runs.off, runs.eager)
    [(key, segs)] = runs.off_entries.items()
    assert len(key[0]) == 4 and "traced" not in key[0]
    assert not segs.traced and not hasattr(segs, "ring")
    assert not runs.setup_off


def test_tracing_on_gives_the_same_results_under_a_second_key(runs):
    for res in runs.on:
        assert equal(res, runs.off)
    (off_key, off_segs), = runs.off_entries.items()
    traced = [k for k in runs.entries if k != off_key]
    assert [k[0] for k in traced] == [off_key[0] + ("traced",)]
    assert runs.entries[off_key] is off_segs and not off_segs.traced
    assert [c["first"] for c in runs.rep["calls"]] == [True, False]


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_compiled_key_is_found_with_tracing_off_or_on(runs,
                                                               traced):
    (config, settings, return_warm, tail_key), dev, segs = runs.last[traced]
    assert (config, settings) == (runs.cfg, runs.cfg.qp_settings())
    assert not return_warm and tail_key is None and dev.type == "cpu"
    assert segs.traced == traced
    assert runs.entries[next(k for k, s in runs.entries.items()
                             if s is segs)] is segs


@pytest.mark.parametrize("call", [0, 1])
def test_stage_spans_are_in_order_inside_the_entry(runs, call):
    c = runs.rep["calls"][call]
    d, host = c["device"], c["host"]
    order = ["load", *profiling.STAGES, "done", "clone"]
    times = [d[n] for n in order]
    assert times == sorted(times)
    t0, t1 = host["entry"]
    assert t0 <= times[0] and times[-1] <= t1
    assert d["done"] - d["prep"] <= t1 - t0
    for name in ("key", "load", "replay", "clone"):
        a, b = host[name]
        assert t0 <= a <= b <= t1
    assert host["load"][1] <= host["replay"][0]


@pytest.mark.parametrize("call", [0, 1])
def test_loop_spans_lie_inside_their_stages_with_the_eager_rounds(runs,
                                                                  call):
    c = runs.rep["calls"][call]
    d = c["device"]
    ends = dict(zip(profiling.STAGES, profiling.STAGES[1:] + ("done",)))
    for loop, where in LOOPS.items():
        assert d[where] <= d[loop + ".start"] <= d[loop + ".stop"] \
            <= d[ends[where]]
        assert c["runs"][loop][0] == runs.stats[f"{loop}_rounds"]
    assert runs.rep["nodes"][0]["loop_stage"] == LOOPS


def test_the_summary_reads_the_calls_that_did_not_capture(runs):
    got = profiling.summarize(runs.rep)
    assert got["calls"] == 1
    assert set(got["stage_ms"]) == set(profiling.STAGES)
    assert sum(got["stage_ms"].values()) == pytest.approx(got["replay_ms"])
    assert got["qp_loop_ms"] == pytest.approx(sum(got["loop_ms"].values()))
    assert got["qp_loop_ms"] <= got["replay_ms"] <= got["device_call_ms"]
    assert got["entry_ms"]["entry"] >= got["entry_ms"]["replay"] > 0
    assert got["graph_nodes"] is None       # no graph on the CPU


@pytest.mark.parametrize("call", [0, 1])
def test_the_corridor_parts_lie_in_order_inside_the_corridor_stage(runs,
                                                                   call):
    d = runs.rep["calls"][call]["device"]
    order = ["corridor", *profiling.CORRIDOR_STAMPS, "post_smooth"]
    times = [d[n] for n in order]
    assert times == sorted(times)
    L, K = runs.cfg.dp_layers, runs.cfg.dp_laterals
    assert runs.rep["nodes"][0]["work"]["lattice"] == dict(
        edges=B * (L - 1) * K * K, shape=[B, L - 1, K],
        table_bytes=2 * 4 * B * (L - 1) * K * K)


def test_the_summary_splits_the_corridor_stage_into_its_parts(runs):
    got = profiling.summarize(runs.rep)
    parts = got["corridor_ms"]
    assert sum(parts[p] for p in profiling.CORRIDOR_PARTS) == \
        pytest.approx(got["stage_ms"]["corridor"])
    assert parts["edges_dp"] == parts["edges"] + parts["dp_forward"]
    assert got["work"]["lattice"]["shape"] == [B, runs.cfg.dp_layers - 1,
                                               runs.cfg.dp_laterals]


# A made-up call: each stamp in turn, ms after the call's start.
MADE_UP = [("load", 0.0), ("prep", 0.5), ("smooth", 4.0),
           ("smooth.start", 4.5), ("smooth.stop", 5.5), ("corridor", 6.0),
           ("corridor.edges", 7.0), ("corridor.dp_forward", 13.5),
           ("corridor.finish", 14.25), ("post_smooth", 15.0),
           ("post.start", 15.5), ("post.stop", 17.5), ("bounds", 18.0),
           ("path_qp", 18.25), ("qp1.start", 19.0), ("qp1.stop", 23.0),
           ("qp2.start", 23.5), ("qp2.stop", 28.0), ("finalize", 28.5),
           ("done", 28.75), ("clone", 29.5)]
MADE_UP_RUNS = {"smooth": [2, 1], "post": [6, 0], "qp1": [5, 2],
                "qp2": [6, 1]}


def made_up_report(corridor_stamps: bool) -> dict:
    """Three calls of one key (the first captures it), each 40 ms after
    the last, with every stamp of :data:`MADE_UP` (the corridor's parts
    only with ``corridor_stamps``)."""
    keep = [(n, t) for n, t in MADE_UP
            if corridor_stamps or n not in profiling.CORRIDOR_STAMPS]
    calls = [dict(call=c, key=0, first=c == 0, host={},
                  device={n: int(1e6 * (40 * c + t)) for n, t in keep},
                  runs=dict(MADE_UP_RUNS)) for c in range(3)]
    work = dict(lattice=dict(edges=256 * 31 * 135 ** 2,
                             shape=[256, 31, 135])) if corridor_stamps else {}
    nodes = dict(stages={}, bodies={}, loop_stage={}, stamps=0, work=work)
    return dict(calls=calls, nodes=[nodes])


def test_the_corridor_parts_of_a_made_up_report_add_up_to_the_stage():
    got = profiling.summarize(made_up_report(True))
    assert got["calls"] == 2
    assert got["corridor_ms"] == pytest.approx(dict(
        nodes=1.0, edges=6.5, dp_forward=0.75, finish=0.75, edges_dp=7.25))
    assert sum(got["corridor_ms"][p] for p in profiling.CORRIDOR_PARTS) \
        == pytest.approx(got["stage_ms"]["corridor"]) == 9.0
    assert got["work"]["lattice"]["shape"] == [256, 31, 135]


@pytest.mark.parametrize("corridor_stamps", [False, True])
def test_the_qp_loops_are_the_four_with_or_without_the_corridor_stamps(
        corridor_stamps):
    got = profiling.summarize(made_up_report(corridor_stamps))
    assert got["loop_ms"] == pytest.approx(
        dict(smooth=1.0, post=2.0, qp1=4.0, qp2=4.5))
    assert got["qp_loop_ms"] == pytest.approx(11.5)
    assert got["rounds"] == dict(smooth=2, post=6, qp1=5, qp2=6)
    assert got["stage_ms"] == pytest.approx(dict(
        prep=3.5, smooth=2.0, corridor=9.0, post_smooth=3.0, bounds=0.25,
        path_qp=10.25, finalize=0.25))
    assert (got["corridor_ms"] is None) == (not corridor_stamps)


def test_executed_nodes_add_each_body_times_its_runs():
    nodes = dict(stages={"smooth": 10, "path_qp": 20, "bounds": 7},
                 bodies={"smooth.round": 5, "smooth.refactor": 3,
                         "qp1.round": 11, "qp1.refactor": 4,
                         "qp2.round": 11},
                 loop_stage={"smooth": "smooth", "qp1": "path_qp",
                             "qp2": "path_qp"})
    got = profiling.executed_nodes(
        nodes, {"smooth": (2, 1), "qp1": (6, 2), "qp2": (3, 0)})
    assert got == {"smooth": 10 + 5 * 2 + 3, "bounds": 7,
                   "path_qp": 20 + 11 * 6 + 4 * 2 + 11 * 3}


@pytest.mark.parametrize("spans, want", [
    # a collection during the clone covers most of the gap: it names it
    ([("clone", 100, 5_000_000), ("gc gen2", 200, 4_900_000)],
     ("gc gen2", 4_899_800)),
    # nothing of the program's covers the gap: the caller's
    ([("load", 0, 50), ("replay", 60, 90)], ("caller", 5_000_000)),
    # the input copy covers the first part, nothing the rest
    ([("input copy", 0, 1_000_000)], ("caller", 4_000_000)),
])
def test_a_gap_is_named_by_the_span_that_covers_most_of_it(spans, want):
    gap = [(100, 1_000_100), (1_000_100, 5_000_100)]
    name, ns, total = profiling.name_gap(gap, spans)
    assert total == 5_000_000
    assert (name, ns) == (want[0], pytest.approx(want[1], abs=200))
    label = profiling.gap_label(644, name, ns, total)
    assert label.startswith(f"call 644: {name} ") and len(label) <= 64


def test_the_longest_gaps_of_calls_are_named_and_sorted():
    """Two calls on made-up stamps: the first's gap (wall less its graph)
    nothing of the program's covers; the second's a collection does."""
    def call(i, prep, done):
        return dict(call=i, host={}, device=dict(prep=prep, done=done))
    rep = dict(calls=[call(0, 1_000_000, 9_000_000),
                      call(1, 11_000_000, 19_000_000)],
               gc=[[19_100_000, 49_000_000, 2, 1]])
    walls = [(0, 10_000_000), (10_000_000, 50_000_000)]
    got = profiling.longest_gaps(rep, rep["calls"], walls)
    assert got == [[32.0, "call 1: gc gen2 29.9 of 32.0 ms"],
                   [2.0, "call 0: caller 2.0 of 2.0 ms"]]


def test_a_collection_is_a_gc_span_with_its_generation():
    with profiling.traced() as tr:
        gc.collect()
    rep = tr.report()
    assert [g[2] for g in rep["gc"]] == [2]
    assert rep["gc"][0][0] <= rep["gc"][0][1]


def test_a_second_call_of_a_key_counts_no_warm_up(monkeypatch):
    """Under a call guard the CPU warms a key up once (the card's capture
    comes there): a second call of the key adds no count and no set-up
    span; a third key in a cache of one evicts one."""
    monkeypatch.setattr(torchutil, "CALL_GUARD", contextlib.nullcontext)
    cache = torchutil.SegmentCache(maxsize=1)
    x = torch.arange(4.0)

    def program(drv, x):
        return drv("neg", torch.neg, x)

    def call(key):
        before = dict(profiling.COUNTS), last_setup_span()
        out, segs = torchutil.compiled(cache, key, program, (x,), "cpu")
        assert torch.equal(out, -x)
        return ({k: v - before[0][k] for k, v in profiling.COUNTS.items()},
                last_setup_span() is not before[1], segs)

    counts, spanned, segs = call("a")
    assert counts == dict(captures=0, warm_ups=1, evictions=0, builds=0)
    assert spanned and [s[0] for s in segs.setup_spans] == ["warm_up"]
    assert profiling.SETUP[-1] is segs.setup_spans[0]
    counts, spanned, _ = call("a")
    assert not any(counts.values()) and not spanned
    counts, _, _ = call("b")
    assert counts["warm_ups"] == 1 and counts["evictions"] == 1
    assert segs.capture_seconds >= 0


@pytest.mark.card
def test_the_untraced_key_holds_no_stamp_on_the_card():
    """At the fine lattice (the corridor's parts stamped), B 8: the
    untraced key's top-level graph has the traced key's nodes less its
    stamps, and its conditional bodies the same nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_pathopt_torch import kernels
    card = torch.device("cuda", 0)
    gm, scs, _ = scenarios.build_adversarial(8, device=card)
    cfg = PlannerConfig(search_lateral_spacing=0.15, dp_laterals=135)
    counted = {"top": [], "bodies": []}
    graph_end, body_end = torch.cuda.CUDAGraph.capture_end, \
        kernels.capture_end

    def top(graph):
        counted["top"].append(kernels.capture_nodes(
            torch.cuda.current_stream().cuda_stream))
        return graph_end(graph)

    def body(stream):
        counted["bodies"].append(kernels.capture_nodes(stream))
        return body_end(stream)

    pipeline.COMPILED.clear()
    torch.cuda.CUDAGraph.capture_end, kernels.capture_end = top, body
    try:
        off = pipeline.solve_batch_jit(gm, scs, cfg, device=card)
        n_bodies = len(counted["bodies"])
        with profiling.traced():
            on = pipeline.solve_batch_jit(gm, scs, cfg, device=card)
    finally:
        torch.cuda.CUDAGraph.capture_end, kernels.capture_end = \
            graph_end, body_end
    _, _, segs = pipeline.last_compiled(traced=True)
    assert equal(on, off)
    assert set(profiling.CORRIDOR_STAMPS) <= set(segs.slots)
    assert counted["top"][0] == counted["top"][1] - segs.stamp_nodes
    assert counted["bodies"][:n_bodies] == counted["bodies"][n_bodies:]
