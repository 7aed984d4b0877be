"""K5, the geometry stage's kernel (``csrc/geometry.cu``,
``pipeline.geometry_kernel``), and its plain version
(``pipeline._geometry_plain``).

On the CPU: the launch plan at every shape the port runs and its limits,
the wrapper's refusals, the C side's limits, formula and argument struct
read from the source, and ``pipeline._geometry`` on CPU tensors taking the
plain chain and counting no launch.

On the card (marked ``card``; skipped without a CUDA device): the kernel
against the plain chain on the card, on the benchmark cells' pools at B
256 and B 1, with dynamic segmentation off, the prescan fallback, the
rough rows' centre corridor, ``golden.CARD_GEOMETRY`` (384 segment points,
long-route lanes) and the long route at 512 and 1024 knots: every output
bit for bit, counts and flags exactly. Then one launch a compiled call.
Run them on the card with ``python3 -m pytest
tests/test_torch_geometry_kernel.py -m card -p no:randomly``.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from tpu_pathopt_torch import (golden, kernels, pipeline, scenarios,
                               torchutil)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_map

ROOT = Path(__file__).resolve().parents[1]
SOURCE = kernels.CSRC / "geometry.cu"
SMALL = dict(n_knots=24, n_segment_points=16, dp_layers=10,
             bspline_samples=48)
def cpp_int(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# What a block may use on the H100 (227 KB), as csrc/common.cuh has it.
MAX_SMEM = cpp_int((kernels.CSRC / "common.cuh").read_text(), "kMaxSmemBytes")
# (S, M, N) of every configuration the port runs: the default, the long
# route, the stretch (384 segment points, 300 layers), 300 and 1024 knots,
# the tests' small config.
PORT_SHAPES = [(64, 32, 128), (128, 96, 512), (384, 300, 512),
               (128, 96, 300), (128, 96, 1024), (16, 10, 24)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------- the plan ------------------------------------

@pytest.mark.parametrize("S,M,N", PORT_SHAPES)
def test_plan_at_the_ports_shapes(S, M, N):
    """2 N threads rounded up to a warp within [128, 512]; the tables, the
    refit's sweeps and the knots' states in shared memory, within a
    block's 227 KB."""
    plan = pipeline.geometry_plan(S, M, N)
    assert plan.threads % 32 == 0
    assert plan.threads == min(512, max(128, -(-2 * N // 32) * 32))
    assert plan.smem == 4 * (9 * S + 16 * M + 4 * N + 64)
    assert plan.smem <= MAX_SMEM


def test_plan_fits_at_its_limits_and_refuses_past_them():
    caps = (pipeline.GEO_MAX_SEGMENT_POINTS, pipeline.GEO_MAX_LAYERS,
            pipeline.GEO_MAX_KNOTS)
    assert pipeline.geometry_plan(*caps).smem <= MAX_SMEM
    for i in range(3):
        past = list(caps)
        past[i] += 1
        with pytest.raises(ValueError, match="the kernel takes"):
            pipeline.geometry_plan(*past)
    for small in ((1, 32, 128), (64, 1, 128), (64, 32, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            pipeline.geometry_plan(*small)




def test_plan_matches_the_launchers_checks():
    """The C launcher refuses any plan but the one geometry_plan makes:
    the same limits and formulas, read from the source."""
    src = SOURCE.read_text()
    names = ("kGeoMaxSegmentPoints", "kGeoMaxLayers", "kGeoMaxKnots",
             "kGeoMaxThreads", "kGeoMinThreads")
    assert tuple(cpp_int(src, n) for n in names) == (
        pipeline.GEO_MAX_SEGMENT_POINTS, pipeline.GEO_MAX_LAYERS,
        pipeline.GEO_MAX_KNOTS, pipeline.GEO_MAX_THREADS,
        pipeline.GEO_MIN_THREADS)
    for expr in ("const int t = (2 * N + 31) / 32 * 32;",
                 "return 4 * (9 * static_cast<size_t>(S) + 16 * "
                 "static_cast<size_t>(M) +\n              4 * "
                 "static_cast<size_t>(N) + 64);",
                 "threads != geometry_threads(a.N)",
                 "static_cast<size_t>(smem_bytes) != geometry_smem_bytes("
                 "a.S, a.M, a.N)",
                 "smem_bytes > kMaxSmemBytes"):
        assert expr in src, expr


def test_arguments_match_the_c_struct():
    """kernels.GeometryArgs lists GeoArgs's members in order, a pointer for
    each pointer, c_int for each int, c_float for each float."""
    body = re.search(r"struct GeoArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    members = re.findall(r"([\w ]+?\*?)\s*(\w+);", body)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [(name, ctypes.c_void_p if "*" in ty else kinds[ty.strip()])
            for ty, name in members]
    assert kernels.GeometryArgs._fields_ == want


# ------------------------------ the wrapper ----------------------------------

def small_inputs(cfg: PlannerConfig, device="cpu"):
    """(gm, scs, xs2, ys2, cor, l_post) of four golden scenarios at
    ``cfg``, as the stages before the geometry stage make them."""
    gm, scs = golden.fixture_batch("default", device)
    scs = tree_map(lambda a: a[:4], scs)
    return (gm, scs) + stage_inputs(gm, scs, cfg)


def stage_inputs(gm, scs, cfg: PlannerConfig):
    """(xs2, ys2, cor, l_post): the geometry stage's other inputs."""
    settings = cfg.qp_settings()
    prep = pipeline.stage_prep(scs, cfg)
    smooth = pipeline.stage_smooth(gm, prep, cfg, settings)
    xs2, ys2, cor = pipeline.stage_corridor(gm, scs, smooth, cfg)
    l_post, _ = pipeline.stage_post_smooth(cor, cfg, settings)
    return xs2, ys2, cor, l_post


@pytest.fixture(scope="module")
def small():
    cfg = PlannerConfig(**SMALL)
    return cfg, small_inputs(cfg)


def test_cpu_takes_the_plain_chain_and_counts_no_launch(small):
    cfg, args = small
    kernels.reset_launches()
    got = pipeline._geometry(*args, cfg)
    want = pipeline._geometry_plain(*args, cfg)
    assert kernels.launches["geometry"] == 0 and kernels.shape_launches == {}
    assert all(torch.equal(g, w) for g, w in zip(
        torchutil.tree_leaves(got), torchutil.tree_leaves(want)))
    with pytest.raises(ValueError, match="CPU tensors"):
        pipeline.geometry_kernel(*args, cfg)


def test_inputs_refuse_other_devices_dtypes_and_shapes(small):
    """geometry_inputs, which the wrapper runs before its launch: inputs on
    another device, of another dtype or shape, raise; a column that is not
    contiguous is copied, not refused."""
    cfg, (gm, scs, xs2, ys2, cor, l_post) = small
    plan, ins = pipeline.geometry_inputs(gm, scs, xs2, ys2, cor, l_post, cfg,
                                         "cpu")
    assert plan == pipeline.geometry_plan(16, 10, 24)
    assert len(ins) == 19 and all(t.is_contiguous() for t in ins)
    with pytest.raises(ValueError, match="expected cuda"):
        pipeline.geometry_inputs(gm, scs, xs2, ys2, cor, l_post, cfg, "cuda")
    bad = {"l_post: dtype torch.float64": dict(l_post=l_post.double()),
           "start_x: shape": dict(scs=dataclasses.replace(
               scs, start_x=scs.start_x[:-1])),
           "cor.n_layers: dtype": dict(cor=dataclasses.replace(
               cor, n_layers=cor.n_layers.int())),
           "xs2.a: shape": dict(xs2=dataclasses.replace(xs2, a=xs2.a[:, :-1]))}
    base = dict(gm=gm, scs=scs, xs2=xs2, ys2=ys2, cor=cor, l_post=l_post)
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            pipeline.geometry_inputs(**{**base, **change}, config=cfg,
                                     device="cpu")
    with pytest.raises(ValueError, match="knots, the kernel takes"):
        pipeline.geometry_inputs(gm, scs, xs2, ys2, cor, l_post,
                                 PlannerConfig(n_knots=4097), "cpu")


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    assert ("Replaces: tpu_pathopt/refpath.py, build_reference_from_spline "
            "(lax.scan at\n// :97), and tpu_pathopt/bounds.py, "
            "update_bounds") in head
    assert "geometry.cu" in kernels.SOURCES
    assert "geometry" in kernels.launches


# ------------------------------- the card ------------------------------------

def flat(geo) -> dict:
    """Every output of the geometry stage by name."""
    ref, cb, init_offset, init_heading_error, ok_init, n_valid = geo
    out = {f"ref.{f.name}": getattr(ref, f.name)
           for f in dataclasses.fields(ref)}
    out.update({f"cb.{f.name}": getattr(cb, f.name)
                for f in dataclasses.fields(cb)})
    out.update(init_offset=init_offset, init_heading_error=init_heading_error,
               ok_init=ok_init, n_valid=n_valid)
    return out


def unequal(got: dict, want: dict) -> dict:
    """Fields whose bits differ (NaN equal to NaN), with the count of
    differing elements and the largest difference."""
    bad = {}
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point:
            diff = (g.contiguous().view(torch.int32)
                    != w.contiguous().view(torch.int32)) & ~(
                        torch.isnan(g) & torch.isnan(w))
            if bool(diff.any()):
                d = (g.double() - w.double()).abs()[diff]
                bad[k] = (int(diff.sum()), float(d.max()))
        elif not torch.equal(g, w):
            bad[k] = (int((g != w).sum()), None)
    return bad


def harness_pool(batch: int, seed: int, device):
    """The benchmark's map and a batch of its traffic (h100_bench's
    generator): ``batch`` queries, a quarter per lane."""
    from h100_bench.core import manifest, port, traffic
    conf = manifest.read(ROOT / "h100_bench" / "configs" / "default.json")
    t = manifest.read(ROOT / "h100_bench" / "traffic" / "cold256.json")
    gm = port.build_map(conf, device)
    a = traffic.arrays(conf, t, batch, traffic.batch_seeds(seed, 1)[0])
    return gm, port.scenario_batch(a, device)


SEED = 5170000017
FAMILIES = {
    "cold256": (256, {}),
    "single_pool": (64, {}),
    "no_dynamic": (256, dict(enable_dynamic_segmentation=False)),
    "prescan": (256, dict(directional_prescan_fallback=True)),
    "rough": (256, dict(rough_constraints_far_away=True)),
}


def compare_on_card(gm, scs, cfg, inputs=None):
    xs2, ys2, cor, l_post = inputs or stage_inputs(gm, scs, cfg)
    kernels.reset_launches()
    got = flat(pipeline._geometry(gm, scs, xs2, ys2, cor, l_post, cfg))
    assert kernels.launches["geometry"] == 1
    want = flat(pipeline._geometry_plain(gm, scs, xs2, ys2, cor, l_post,
                                         cfg))
    torch.cuda.synchronize()
    return unequal(got, want), got


@pytest.mark.card
@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_equals_the_plain_chain_on_the_card(family, card):
    pipeline._set_precision()
    batch, knobs = FAMILIES[family]
    gm, scs = harness_pool(batch, SEED, card)
    bad, got = compare_on_card(gm, scs, PlannerConfig(**knobs))
    assert bad == {}, bad
    assert bool(torch.isfinite(got["ref.x"]).all())


@pytest.mark.card
def test_kernel_equals_the_plain_chain_one_query_at_a_time(card):
    """The single cell's calls: B 1."""
    pipeline._set_precision()
    gm, scs = harness_pool(8, SEED + 1, card)
    for row in range(8):
        one = tree_map(lambda a, r=row: a[r:r + 1], scs)
        bad, _ = compare_on_card(gm, one, PlannerConfig())
        assert bad == {}, (row, bad)


@pytest.mark.card
def test_kernel_equals_the_plain_chain_on_the_card_geometry_inputs(card):
    """golden.CARD_GEOMETRY: the inputs the card once turned NaN, 384
    segment points, 300 layers, 512 knots."""
    d = golden.card_geometry(card)
    cfg = PlannerConfig(**scenarios.STRETCH_CONFIG)
    bad, got = compare_on_card(d["gm"], d["scs"], cfg, (
        d["xs2"], d["ys2"], d["cor"], d["l_post"]))
    assert bad == {}, bad
    n = got["n_valid"]
    assert bool((n > 0).all())
    mask = torch.arange(cfg.n_knots, device=card) < n[:, None]
    for f in ("x", "y", "heading", "k"):
        assert bool(torch.isfinite(got[f"ref.{f}"][mask]).all()), f


@pytest.mark.card
@pytest.mark.parametrize("knots", [512, 1024])
def test_kernel_equals_the_plain_chain_on_the_long_route(knots, card):
    pipeline._set_precision()
    gm, scs, _ = scenarios.build_long_route(16, device=card)
    cfg = PlannerConfig(**dict(scenarios.LONG_CONFIG, n_knots=knots))
    bad, _ = compare_on_card(gm, scs, cfg)
    assert bad == {}, bad


@pytest.mark.card
@pytest.mark.parametrize("batch", [16, 1])
def test_one_launch_a_compiled_call(batch, card):
    """The compiled call replays K5 once: sync_counts shows one
    geometry[M=32,N=128] launch a call, through solve_batch_jit (B 16) and
    solve_jit (one query), as the eager path launches it."""
    gm, scs = harness_pool(16, SEED + 2, card)
    cfg = PlannerConfig()
    if batch == 1:
        sc = tree_map(lambda a: a[0], scs)
        call = lambda: pipeline.solve_jit(gm, sc, cfg)  # noqa: E731
    else:
        call = lambda: pipeline.solve_batch_jit(gm, scs, cfg)  # noqa: E731
    call()
    kernels.reset_launches()
    for _ in range(3):
        call()
    kernels.sync_counts()
    assert kernels.shape_launches["geometry[M=32,N=128]"] == 3
