"""K7, the prep stage's kernel (``csrc/prep.cu``, ``pipeline.prep_kernel``),
and its plain chain (``pipeline._prep_plain``: ``bspline.fit_and_sample``,
then ``smoothing.segment.segment_raw_reference``).

On the CPU: the launch plan at every shape the port runs and its limits,
the C side's limits, formula and argument struct read from the source, the
wrapper's refusals, ``stage_prep`` on CPU tensors taking the plain chain
and counting no launch, and the plain chain's float64 arc-length sum equal
to the float32 cumsum it replaced.

On the card (marked ``card``; skipped without a CUDA device): the kernel
against the plain chain on the card, on the benchmark cells' pool and the
adversarial batch at B 256, one query at a time (B 1), on the long route
(128 segment points) and its stretch (384), at the CLI's 64 samples and on
random routes that take every degree, 1 to R raw points, and R up to the
plan's limit: every output bit for bit. Then one launch a compiled call,
and the traced key's graph down by at least 3,000 nodes against the plain
chain. Run them on the card with ``python3 -m pytest
tests/test_torch_prep_kernel.py -m card --noconftest -o addopts=""``.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from tpu_pathopt_torch import (bspline, golden, kernels, pipeline, profiling,
                               scenarios, torchutil)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_map

from test_torch_geometry_kernel import harness_pool, unequal

SOURCE = kernels.CSRC / "prep.cu"
CLI = dict(n_knots=64, n_segment_points=32, dp_layers=24,
           bspline_samples=64)


def cpp_int(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# What a block may use on the H100 (227 KB), as csrc/common.cuh has it.
MAX_SMEM = cpp_int((kernels.CSRC / "common.cuh").read_text(), "kMaxSmemBytes")
# (R, T, P) of every configuration the port runs: the default, the CLI, the
# long route, its stretch, and the tests' small config.
PORT_SHAPES = [(16, 256, 64), (16, 64, 32), (16, 256, 128), (16, 256, 384),
               (16, 48, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------- the plan ------------------------------------

@pytest.mark.parametrize("R,T,P", PORT_SHAPES)
def test_plan_at_the_ports_shapes(R, T, P):
    """max(T, P) threads rounded up to a warp, at most 512; the samples'
    table and sweeps and the raw points in shared memory, within a block's
    227 KB."""
    plan = pipeline.prep_plan(R, T, P)
    assert plan.threads % 32 == 0
    assert plan.threads == min(512, -(-max(T, P) // 32) * 32)
    assert plan.threads >= min(512, max(T, P))
    assert plan.smem == 4 * (16 * T + 2 * R)
    assert plan.smem <= MAX_SMEM


def test_plan_fits_at_its_limits_and_refuses_past_them():
    caps = (pipeline.PREP_MAX_RAW, pipeline.PREP_MAX_SAMPLES,
            pipeline.PREP_MAX_POINTS)
    assert pipeline.prep_plan(*caps).smem <= MAX_SMEM
    assert pipeline.prep_plan(*caps).threads == pipeline.PREP_MAX_THREADS
    for i in range(3):
        past = list(caps)
        past[i] += 1
        with pytest.raises(ValueError, match="the kernel takes"):
            pipeline.prep_plan(*past)
    for small in ((1, 256, 64), (16, 1, 64), (16, 256, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            pipeline.prep_plan(*small)


def test_plan_matches_the_launchers_checks():
    """The C launcher refuses any plan but the one prep_plan makes: the
    same limits and formulas, read from the source."""
    src = SOURCE.read_text()
    names = ("kPrepMaxRaw", "kPrepMaxSamples", "kPrepMaxPoints",
             "kPrepMaxThreads")
    assert tuple(cpp_int(src, n) for n in names) == (
        pipeline.PREP_MAX_RAW, pipeline.PREP_MAX_SAMPLES,
        pipeline.PREP_MAX_POINTS, pipeline.PREP_MAX_THREADS)
    for expr in ("const int t = ((T > P ? T : P) + 31) / 32 * 32;",
                 "return t > kPrepMaxThreads ? kPrepMaxThreads : t;",
                 "return 4 * (16 * static_cast<size_t>(T) + 2 * "
                 "static_cast<size_t>(R));",
                 "threads != prep_threads(a.T, a.P)",
                 "static_cast<size_t>(smem_bytes) != prep_smem_bytes(a.R, "
                 "a.T)",
                 "smem_bytes > kMaxSmemBytes"):
        assert expr in src, expr


def test_arguments_match_the_c_struct():
    """kernels.PrepArgs lists PrepArgs's members in order, a pointer for
    each pointer, c_int for each int."""
    body = re.search(r"struct PrepArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    members = re.findall(r"([\w ]+?\*?)\s*(\w+);", body)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [(name, ctypes.c_void_p if "*" in ty else kinds[ty.strip()])
            for ty, name in members]
    assert kernels.PrepArgs._fields_ == want


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    assert ("Replaces: tpu_pathopt/bspline.py, fit_and_sample, and\n"
            "// tpu_pathopt/smoothing/segment.py, segment_raw_reference. "
            "These are no\n// Pallas kernels") in head
    assert "What bounds it on the H100: not bytes." in head
    assert "prep.cu" in kernels.SOURCES
    assert "splines.cuh" in kernels.HEADERS
    assert "prep" in kernels.launches


# ------------------------------ the wrapper ----------------------------------

@pytest.fixture(scope="module")
def small():
    _, scs = golden.fixture_batch("default", "cpu")
    return PlannerConfig(**CLI), scs


def leaves_equal(a, b) -> bool:
    la, lb = torchutil.tree_leaves(a), torchutil.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_cpu_takes_the_plain_chain_and_counts_no_launch(small):
    cfg, scs = small
    kernels.reset_launches()
    got = pipeline.stage_prep(scs, cfg)
    assert kernels.launches["prep"] == 0 and kernels.shape_launches == {}
    assert leaves_equal(got, pipeline._prep_plain(scs, cfg))
    assert [t.dtype for t in got] == [torch.bool] + [torch.float32] * 5 + [
        torch.int64]
    with pytest.raises(ValueError, match="CPU tensors"):
        pipeline.prep_kernel(scs, cfg)


def test_inputs_refuse_other_devices_dtypes_and_shapes(small):
    """prep_inputs, which the wrapper runs before its launch: inputs on
    another device, of another dtype or shape, raise; a column that is not
    contiguous is copied, not refused; shapes past the plan's limits
    raise."""
    cfg, scs = small
    wide = dataclasses.replace(
        scs, raw_x=torch.cat([scs.raw_x, scs.raw_x], 1)[:, ::2])
    assert not wide.raw_x.is_contiguous()
    plan, ins = pipeline.prep_inputs(wide, cfg, "cpu")
    assert plan == pipeline.prep_plan(16, 64, 32)
    assert len(ins) == 3 and all(t.is_contiguous() for t in ins)
    assert [f for f, _ in kernels.PrepArgs._fields_[:3]] == [
        "raw_x", "raw_y", "n_raw"]
    with pytest.raises(ValueError, match="expected cuda"):
        pipeline.prep_inputs(scs, cfg, "cuda")
    bad = {"raw_x: dtype torch.float64": dict(raw_x=scs.raw_x.double()),
           "raw_y: shape": dict(raw_y=scs.raw_y[:-1]),
           "n_raw: dtype": dict(n_raw=scs.n_raw.int()),
           "n_raw: shape": dict(n_raw=scs.n_raw[:, None])}
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            pipeline.prep_inputs(dataclasses.replace(scs, **change), cfg,
                                 "cpu")
    for knobs, what in ((dict(bspline_samples=1025), "B-spline samples"),
                        (dict(n_segment_points=1025), "segment points")):
        with pytest.raises(ValueError, match=f"{what}, the kernel takes"):
            pipeline.prep_inputs(scs, PlannerConfig(**knobs), "cpu")
    B = scs.raw_x.shape[0]
    many = dataclasses.replace(
        scs, raw_x=torch.zeros(B, pipeline.PREP_MAX_RAW + 1),
        raw_y=torch.zeros(B, pipeline.PREP_MAX_RAW + 1))
    with pytest.raises(ValueError, match="raw points, the kernel takes"):
        pipeline.prep_inputs(many, cfg, "cpu")


def test_float64_arc_length_equals_the_float32_cumsum_on_the_cpu(small):
    """The plain chain sums the samples' arc length in float64 and rounds
    once (the GPU's float32 cumsum sums in another order); on the CPU this
    is the float32 cumsum's value, which sums in float64 already: on random
    segments and on the fixture batch's samples."""
    g = torch.Generator().manual_seed(5)
    seg = torch.rand(512, 255, generator=g) * torch.logspace(
        -4, 2, 255)[torch.randperm(255, generator=g)]
    assert torch.equal(torch.cumsum(seg, -1), torch.cumsum(
        seg, -1, dtype=torch.float64).to(torch.float32))
    cfg, scs = small
    xs, ys, s, n = bspline.fit_and_sample(scs.raw_x, scs.raw_y, scs.n_raw,
                                          256)
    d = torch.hypot(torch.diff(xs, dim=-1), torch.diff(ys, dim=-1))
    d = torch.where(torch.arange(1, 256) < n[:, None], d, 0.0)
    old = torch.cat([torch.zeros_like(d[:, :1]), torch.cumsum(d, -1)], -1)
    assert torch.equal(s, old)


def test_the_benchmarks_reader_reads_the_prep_stage():
    """h100_bench's call_stage_ms.prep reads the in-call reading's prep
    stage, and nothing where nothing was read."""
    from h100_bench.core import manifest
    read = manifest.module(
        manifest.HERE / "metrics" / "call_stage_ms.prep.py").read
    stages = dict(prep=0.101, smooth=1.38, corridor=2.0, post_smooth=2.4,
                  bounds=0.096, path_qp=10.4, finalize=0.05)
    assert read({"incall": dict(stage_ms=stages)}) == 0.101
    assert read({"incall": None}) is None
    assert read({"incall": {}}) is None


# ------------------------------- the card ------------------------------------

def random_routes(batch: int, R: int, seed: int, device):
    """Scenarios whose raw routes take every degree (average spacing about
    2 to 15 m), 1 to R valid points, padded by repeating the last."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, R + 1, batch)
    n[:3] = (1, 2, R)
    step = rng.uniform(2.0, 15.0, batch)[:, None] * rng.uniform(
        0.6, 1.4, (batch, R))
    head = np.cumsum(rng.normal(0.0, 0.3, (batch, R)), 1)
    x = np.cumsum(step * np.cos(head), 1) - 30.0
    y = np.cumsum(step * np.sin(head), 1) - 10.0
    pad = np.arange(R)[None] >= n[:, None]
    last = np.take_along_axis(x, n[:, None] - 1, 1)
    x = np.where(pad, last, x)
    y = np.where(pad, np.take_along_axis(y, n[:, None] - 1, 1), y)
    f = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=device)
    z = f(np.zeros(batch))
    return pipeline.Scenario(
        raw_x=f(x), raw_y=f(y),
        n_raw=torch.tensor(n, dtype=torch.int64, device=device),
        start_x=z, start_y=z, start_heading=z, start_k=z, target_x=z,
        target_y=z, target_heading=z)


NAMES = ("ok_input", "x", "y", "s", "angle", "k", "n_valid")


def compare_on_card(scs, cfg):
    kernels.reset_launches()
    got = dict(zip(NAMES, pipeline.prep_kernel(scs, cfg)))
    B, R = scs.raw_x.shape
    assert kernels.shape_launches == {
        f"prep[R={R},T={cfg.bspline_samples},P={cfg.n_segment_points}]": 1}
    want = dict(zip(NAMES, pipeline._prep_plain(scs, cfg)))
    torch.cuda.synchronize()
    return unequal(got, want), got


SEED = 5210000021


@pytest.mark.card
@pytest.mark.parametrize("family", ["cold256", "adversarial"])
def test_kernel_equals_the_plain_chain_on_the_card(family, card):
    pipeline._set_precision()
    if family == "cold256":
        _, scs = harness_pool(256, SEED, card)
    else:
        _, scs, _ = scenarios.build_adversarial(256, device=card)
    bad, got = compare_on_card(scs, PlannerConfig())
    assert bad == {}, bad
    assert bool(got["ok_input"].all())
    assert bool(torch.isfinite(got["k"]).all())


@pytest.mark.card
def test_kernel_equals_the_plain_chain_one_query_at_a_time(card):
    """The single cell's calls: B 1."""
    pipeline._set_precision()
    _, scs = harness_pool(8, SEED + 1, card)
    for row in range(8):
        one = tree_map(lambda a, r=row: a[r:r + 1], scs)
        bad, _ = compare_on_card(one, PlannerConfig())
        assert bad == {}, (row, bad)


@pytest.mark.card
@pytest.mark.parametrize("config", ["LONG_CONFIG", "STRETCH_CONFIG", "CLI"])
def test_kernel_equals_the_plain_chain_on_other_shapes(config, card):
    """128 and 384 segment points on the long route, and the CLI's 64
    samples and 32 points on the benchmark's pool."""
    pipeline._set_precision()
    if config == "CLI":
        _, scs = harness_pool(64, SEED + 2, card)
        cfg = PlannerConfig(**CLI)
    else:
        _, scs, _ = scenarios.build_long_route(16, device=card)
        cfg = PlannerConfig(**getattr(scenarios, config))
    bad, _ = compare_on_card(scs, cfg)
    assert bad == {}, bad


@pytest.mark.card
@pytest.mark.parametrize("R", [16, 40, pipeline.PREP_MAX_RAW])
def test_kernel_equals_the_plain_chain_on_random_routes(R, card):
    """Every degree, 1 to R raw points (the chain's sum of R - 1 segments
    takes 8, 32 and 32 lanes, with 1 to 4 accumulators a lane, the last at
    the plan's limit)."""
    pipeline._set_precision()
    scs = random_routes(256, R, SEED + R, card)
    bad, got = compare_on_card(scs, PlannerConfig())
    assert bad == {}, bad
    assert not bool(got["ok_input"][:2].any())


def compiled_call(gm, scs, batch: int):
    cfg = PlannerConfig()
    if batch == 1:
        sc = tree_map(lambda a: a[0], scs)
        return lambda: pipeline.solve_jit(gm, sc, cfg)
    return lambda: pipeline.solve_batch_jit(gm, scs, cfg)


@pytest.mark.card
@pytest.mark.parametrize("batch", [16, 1])
def test_one_launch_a_compiled_call(batch, card):
    """The compiled call replays K7 once: sync_counts shows one
    prep[R=16,T=256,P=64] launch a call, through solve_batch_jit (B 16) and
    solve_jit (one query), as the eager path launches it."""
    gm, scs = harness_pool(16, SEED + 4, card)
    call = compiled_call(gm, scs, batch)
    call()
    kernels.reset_launches()
    for _ in range(3):
        call()
    kernels.sync_counts()
    assert kernels.shape_launches["prep[R=16,T=256,P=64]"] == 3


@pytest.mark.card
def test_traced_graph_loses_the_chains_nodes(card, monkeypatch):
    """At the default shapes, B 16: the traced key executes at least 3,000
    nodes fewer with K7 than with the plain chain, the difference all in
    the prep stage, and the results are equal."""
    gm, scs = harness_pool(16, SEED + 5, card)
    call = compiled_call(gm, scs, 16)

    def traced():
        pipeline.COMPILED.clear()
        with profiling.traced() as tr:
            for _ in range(3):
                out = call()
            rep = tr.report()
        got = profiling.summarize(rep)
        return got["graph_nodes"], got["stage_nodes"], out

    nodes, stages, res = traced()
    with monkeypatch.context() as m:
        m.setattr(pipeline, "prep_kernel", pipeline._prep_plain)
        nodes_plain, stages_plain, res_plain = traced()
    pipeline.COMPILED.clear()
    assert nodes_plain - nodes >= 3000, (nodes, nodes_plain)
    assert {s for s in stages if stages[s] != stages_plain[s]} == {"prep"}
    assert leaves_equal(res, res_plain)
