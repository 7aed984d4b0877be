"""K6, the DP corridor's lattice kernel (``csrc/lattice.cu``,
``corridor.refit_lattice_kernel`` and ``corridor.lattice_kernel``), and
its plain chain (``corridor.refit_lattice_plain``: ``splines.refit``, then
``corridor.lattice_nodes_plain``).

On the CPU: the launch plan at every shape the port runs and its limits,
the C side's limits, formula and argument struct read from the source, the
wrapper's refusals, ``prepare_lattice`` and ``refit_lattice`` on CPU
tensors taking the plain chain and counting no launch, and the A* search
counting no K6 launch.

On the card (marked ``card``; skipped without a CUDA device): the kernel
against the plain chain on the card, on the benchmark cells' pools at B
256 and B 1 at 35 and at 135 laterals, on the long route (96 layers) and
its stretch (384 segment points, 300 layers), and with the spline given
(``prepare_lattice``'s own path): every output bit for bit. Then one
launch a compiled call, and the traced key's graph down by at least 3,000
nodes against the plain chain. Run them on the card with ``python3 -m
pytest tests/test_torch_lattice_kernel.py -m card --noconftest -o
addopts=""``.
"""

import ctypes
import dataclasses
import re

import pytest
import torch

from tpu_pathopt_torch import (corridor, golden, kernels, pipeline,
                               profiling, scenarios, splines, torchutil)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_map

from test_torch_geometry_kernel import harness_pool, unequal

SOURCE = kernels.CSRC / "lattice.cu"
SMALL = dict(n_knots=24, n_segment_points=16, dp_layers=10,
             bspline_samples=48)
FINE = dict(search_lateral_spacing=0.15, dp_laterals=135)


def cpp_int(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# What a block may use on the H100 (227 KB), as csrc/common.cuh has it.
MAX_SMEM = cpp_int((kernels.CSRC / "common.cuh").read_text(), "kMaxSmemBytes")
# (S, L, K) of every configuration the port runs on the card: the default,
# the fine lattice, the long route (also at 300 and 1024 knots), its
# stretch, and the tests' small config.
PORT_SHAPES = [(64, 32, 35), (64, 32, 135), (128, 96, 35), (384, 300, 35),
               (16, 10, 35)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------- the plan ------------------------------------

@pytest.mark.parametrize("S,L,K", PORT_SHAPES)
def test_plan_at_the_ports_shapes(S, L, K):
    """32 ceil(L K / 256) threads within [256, 512]; the route's table and
    sweeps, the layers' frame, the feasibility bits and the reductions in
    shared memory, within a block's 227 KB."""
    plan = corridor.lattice_plan(S, L, K)
    assert plan.threads % 32 == 0
    assert plan.threads == min(512, max(256, -(-L * K // 256) * 32))
    assert plan.smem == 4 * (16 * S + 6 * L + L * -(-K // 32) + 64)
    assert plan.smem <= MAX_SMEM


def test_plan_fits_at_its_limits_and_refuses_past_them():
    caps = (corridor.LAT_MAX_SEGMENT_POINTS, corridor.LAT_MAX_LAYERS,
            corridor.LAT_MAX_LATERALS)
    assert corridor.lattice_plan(*caps).smem <= MAX_SMEM
    assert corridor.lattice_plan(*caps).threads == corridor.LAT_MAX_THREADS
    for i in range(3):
        past = list(caps)
        past[i] += 1
        with pytest.raises(ValueError, match="the kernel takes"):
            corridor.lattice_plan(*past)
    for small in ((1, 32, 35), (64, 1, 35), (64, 32, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            corridor.lattice_plan(*small)


def test_plan_matches_the_launchers_checks():
    """The C launcher refuses any plan but the one lattice_plan makes: the
    same limits and formulas, read from the source."""
    src = SOURCE.read_text()
    names = ("kLatMaxSegmentPoints", "kLatMaxLayers", "kLatMaxLaterals",
             "kLatMinThreads", "kLatMaxThreads")
    assert tuple(cpp_int(src, n) for n in names) == (
        corridor.LAT_MAX_SEGMENT_POINTS, corridor.LAT_MAX_LAYERS,
        corridor.LAT_MAX_LATERALS, corridor.LAT_MIN_THREADS,
        corridor.LAT_MAX_THREADS)
    for expr in ("const int t = (L * K + 255) / 256 * 32;",
                 "return 4 * (16 * static_cast<size_t>(S) + 6 * "
                 "static_cast<size_t>(L) +\n              static_cast<size_t>"
                 "(L) * ((K + 31) / 32) + 64);",
                 "threads != lattice_threads(a.L, a.K)",
                 "static_cast<size_t>(smem_bytes) != lattice_smem_bytes(a.S, "
                 "a.L, a.K)",
                 "smem_bytes > kMaxSmemBytes"):
        assert expr in src, expr


def test_arguments_match_the_c_struct():
    """kernels.LatticeArgs lists LatArgs's members in order, a pointer for
    each pointer, c_int for each int, c_float for each float."""
    body = re.search(r"struct LatArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    members = re.findall(r"([\w ]+?\*?)\s*(\w+);", body)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [(name, ctypes.c_void_p if "*" in ty else kinds[ty.strip()])
            for ty, name in members]
    assert kernels.LatticeArgs._fields_ == want


def test_source_names_what_it_replaces():
    head = SOURCE.read_text().split("#include")[0]
    assert ("Replaces: tpu_pathopt/corridor.py, _build_lattice_geom, "
            "prepare_lattice's\n// feasibility and _rough_bounds, and "
            "tpu_pathopt/pipeline.py,\n// _refit_splines. These are no "
            "Pallas kernels") in head
    assert "What bounds it on the H100: not bytes." in head
    assert "lattice.cu" in kernels.SOURCES
    assert "splines.cuh" in kernels.HEADERS
    assert "lattice" in kernels.launches


# ------------------------------ the wrapper ----------------------------------

def route_inputs(gm, scs, cfg: PlannerConfig):
    """(x, y, n_valid): the smoothed route the corridor stage refits."""
    prep = pipeline.stage_prep(scs, cfg)
    x, y, _, n, _ = pipeline.stage_smooth(gm, prep, cfg, cfg.qp_settings())
    return x, y, n


@pytest.fixture(scope="module")
def small():
    cfg = PlannerConfig(**SMALL)
    gm, scs = golden.fixture_batch("default", "cpu")
    scs = tree_map(lambda a: a[:4], scs)
    return cfg, gm, scs, route_inputs(gm, scs, cfg)


def leaves_equal(a, b) -> bool:
    la, lb = torchutil.tree_leaves(a), torchutil.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_cpu_takes_the_plain_chain_and_counts_no_launch(small):
    cfg, gm, scs, (x, y, n) = small
    kernels.reset_launches()
    xs, ys, lat = corridor.refit_lattice(gm, x, y, n, scs.start_x,
                                         scs.start_y, scs.start_heading, cfg)
    xs_p, ys_p, s_max = splines.refit(x, y, n)
    length = s_max + corridor.ROUTE_EXTENSION
    want = corridor.edge_costs(corridor.lattice_nodes_plain(
        gm, xs_p, ys_p, length, scs.start_x, scs.start_y, cfg),
        scs.start_heading, cfg)
    assert leaves_equal(corridor.refit_lattice_plain(
        gm, x, y, n, scs.start_x, scs.start_y, cfg)[2], length)
    got = corridor.prepare_lattice(gm, xs_p, ys_p, length, scs.start_x,
                                   scs.start_y, scs.start_heading, cfg)
    assert kernels.launches["lattice"] == 0 and kernels.shape_launches == {}
    assert leaves_equal((xs, ys), (xs_p, ys_p))
    assert leaves_equal(lat, want) and leaves_equal(got, want)
    with pytest.raises(ValueError, match="CPU tensors"):
        corridor.refit_lattice_kernel(gm, x, y, n, scs.start_x, scs.start_y,
                                      cfg)
    with pytest.raises(ValueError, match="CPU tensors"):
        corridor.lattice_kernel(gm, xs_p, ys_p, length, scs.start_x,
                                scs.start_y, cfg)


def test_inputs_refuse_other_devices_dtypes_and_shapes(small):
    """lattice_inputs, which the wrapper runs before its launch: inputs on
    another device, of another dtype or shape, raise; a column that is not
    contiguous is copied, not refused; a lattice past the plan's limits
    raises."""
    cfg, gm, scs, (x, y, n) = small
    xs, ys, s_max = splines.refit(x, y, n)
    spline = (xs.s, xs.a, xs.b, xs.c, ys.a, ys.b, ys.c)
    base = dict(gm=gm, x=x, y=y, n_valid=n, spline=spline,
                length=s_max + 3.0, start_x=scs.start_x,
                start_y=scs.start_y, config=cfg)
    assert not x.is_contiguous()
    plan, ins = corridor.lattice_inputs(**base, device="cpu")
    assert plan == corridor.lattice_plan(16, 10, 35)
    assert len(ins) == 14 and all(t.is_contiguous() for t in ins)
    assert [f for f, _ in kernels.LatticeArgs._fields_[:14]] == [
        "x", "y", "n_valid", "s", "xa", "xb", "xc", "ya", "yb", "yc",
        "length", "start_x", "start_y", "quad"]
    with pytest.raises(ValueError, match="expected cuda"):
        corridor.lattice_inputs(**base, device="cuda")
    bad = {"x: dtype torch.float64": dict(x=x.double()),
           "start_y: shape": dict(start_y=scs.start_y[:-1]),
           "n_valid: dtype": dict(n_valid=n.int()),
           "xs.b: shape": dict(spline=(xs.s, xs.a, xs.b[:, :-1], xs.c, ys.a,
                                       ys.b, ys.c)),
           "length: shape": dict(length=s_max[:, None])}
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            corridor.lattice_inputs(**{**base, **change}, device="cpu")
    for knobs, what in ((dict(dp_laterals=301), "laterals"),
                        (dict(dp_layers=301), "layers")):
        with pytest.raises(ValueError, match=f"{what}, the kernel takes"):
            corridor.lattice_inputs(**{**base, "config": PlannerConfig(
                **knobs)}, device="cpu")


def test_astar_counts_no_lattice_launch(small):
    """The A* search keeps its plain chain: its corridor stage counts no
    K6 launch."""
    cfg, gm, scs, _ = small
    cfg = dataclasses.replace(cfg, corridor_method="ASTAR")
    prep = pipeline.stage_prep(scs, cfg)
    smooth = pipeline.stage_smooth(gm, prep, cfg, cfg.qp_settings())
    kernels.reset_launches()
    _, _, cor = pipeline.stage_corridor(gm, scs, smooth, cfg)
    assert kernels.launches["lattice"] == 0
    assert kernels.launches["dp_forward"] == 0
    assert bool((cor.n_layers >= 1).all())


# ------------------------------- the card ------------------------------------

def flat(xs, ys, length, nodes) -> dict:
    """Every output of the refit and the lattice's nodes by name."""
    out = {f"{name}.{f}": getattr(sp, f) for name, sp in (("xs", xs),
                                                          ("ys", ys))
           for f in ("s", "y", "a", "b", "c", "n_valid")}
    out["length"] = length
    out.update({f.name: getattr(nodes, f.name)
                for f in dataclasses.fields(nodes)})
    return out


def compare_on_card(gm, scs, cfg):
    x, y, n = route_inputs(gm, scs, cfg)
    kernels.reset_launches()
    got = flat(*corridor.refit_lattice_kernel(gm, x, y, n, scs.start_x,
                                              scs.start_y, cfg))
    assert kernels.shape_launches == {
        f"lattice[L={cfg.dp_layers},K={cfg.dp_laterals}]": 1}
    want = flat(*corridor.refit_lattice_plain(gm, x, y, n, scs.start_x,
                                              scs.start_y, cfg))
    torch.cuda.synchronize()
    return unequal(got, want), got


SEED = 5190000019
FAMILIES = {
    "cold256": (256, {}),
    "fine256": (256, FINE),
}


@pytest.mark.card
@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_equals_the_plain_chain_on_the_card(family, card):
    pipeline._set_precision()
    batch, knobs = FAMILIES[family]
    gm, scs = harness_pool(batch, SEED, card)
    bad, got = compare_on_card(gm, scs, PlannerConfig(**knobs))
    assert bad == {}, bad
    assert bool(got["ok"].all())
    assert bool(torch.isfinite(got["node_x"]).all())


@pytest.mark.card
@pytest.mark.parametrize("knobs", [{}, FINE], ids=["35", "135"])
def test_kernel_equals_the_plain_chain_one_query_at_a_time(knobs, card):
    """The single cell's calls: B 1."""
    pipeline._set_precision()
    gm, scs = harness_pool(8, SEED + 1, card)
    for row in range(8):
        one = tree_map(lambda a, r=row: a[r:r + 1], scs)
        bad, _ = compare_on_card(gm, one, PlannerConfig(**knobs))
        assert bad == {}, (row, bad)


@pytest.mark.card
@pytest.mark.parametrize("config", ["LONG_CONFIG", "STRETCH_CONFIG"])
def test_kernel_equals_the_plain_chain_on_the_long_route(config, card):
    """96 layers of 128 segment points, and the stretch's 300 of 384."""
    pipeline._set_precision()
    gm, scs, _ = scenarios.build_long_route(16, device=card)
    cfg = PlannerConfig(**getattr(scenarios, config))
    bad, _ = compare_on_card(gm, scs, cfg)
    assert bad == {}, bad


@pytest.mark.card
def test_kernel_takes_a_given_spline_on_the_card(card):
    """prepare_lattice's path (corridor.lattice_kernel): the spline and the
    length given, the nodes bit for bit the plain chain's."""
    pipeline._set_precision()
    gm, scs = harness_pool(256, SEED + 2, card)
    cfg = PlannerConfig()
    xs, ys, s_max = splines.refit(*route_inputs(gm, scs, cfg))
    length = s_max + corridor.ROUTE_EXTENSION
    kernels.reset_launches()
    nodes = corridor.lattice_nodes(gm, xs, ys, length, scs.start_x,
                                   scs.start_y, cfg)
    assert kernels.launches["lattice"] == 1
    want = corridor.lattice_nodes_plain(gm, xs, ys, length, scs.start_x,
                                        scs.start_y, cfg)
    torch.cuda.synchronize()
    bad = unequal(flat(xs, ys, length, nodes), flat(xs, ys, length, want))
    assert bad == {}, bad


@pytest.mark.card
def test_astar_counts_no_lattice_launch_on_the_card(card):
    gm, scs = harness_pool(16, SEED + 3, card)
    cfg = PlannerConfig(corridor_method="ASTAR")
    prep = pipeline.stage_prep(scs, cfg)
    smooth = pipeline.stage_smooth(gm, prep, cfg, cfg.qp_settings())
    kernels.reset_launches()
    pipeline.stage_corridor(gm, scs, smooth, cfg)
    assert kernels.launches["lattice"] == 0


def compiled_call(gm, scs, batch: int):
    cfg = PlannerConfig()
    if batch == 1:
        sc = tree_map(lambda a: a[0], scs)
        return lambda: pipeline.solve_jit(gm, sc, cfg)
    return lambda: pipeline.solve_batch_jit(gm, scs, cfg)


@pytest.mark.card
@pytest.mark.parametrize("batch", [16, 1])
def test_one_launch_a_compiled_call(batch, card):
    """The compiled call replays K6 once: sync_counts shows one
    lattice[L=32,K=35] launch a call, through solve_batch_jit (B 16) and
    solve_jit (one query), as the eager path launches it."""
    gm, scs = harness_pool(16, SEED + 4, card)
    call = compiled_call(gm, scs, batch)
    call()
    kernels.reset_launches()
    for _ in range(3):
        call()
    kernels.sync_counts()
    assert kernels.shape_launches["lattice[L=32,K=35]"] == 3


@pytest.mark.card
def test_traced_graph_loses_the_chains_nodes(card, monkeypatch):
    """At the default width, B 16: the traced key executes at least 3,000
    nodes fewer with K6 than with the plain chain, the difference all in
    the corridor stage, and the results are equal."""
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
        m.setattr(corridor, "refit_lattice_kernel",
                  corridor.refit_lattice_plain)
        nodes_plain, stages_plain, res_plain = traced()
    pipeline.COMPILED.clear()
    assert nodes_plain - nodes >= 3000, (nodes, nodes_plain)
    assert {s for s in stages if stages[s] != stages_plain[s]} == {"corridor"}
    assert leaves_equal(res, res_plain)
