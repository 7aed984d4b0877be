"""A whole run on the CPU, at a tiny size: sound, it comes out correct; with
the timed path broken underneath, once for each fault a cell can have, it
comes out not correct. And the control, the reference one precision down,
comes out not correct against the cell's limits."""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from h100_bench import control
from h100_bench.core import manifest, port, trace
from tpu_pathopt_torch import pipeline
from tpu_pathopt_torch.torchutil import tree_map

RUN = runpy.run_path(str(manifest.HERE / "run.py"), run_name="bench_run")
TINY = {"batch": 8, "pool": 1, "sample_per_lane": 1}


def run_cell(cell, capsys, seed=2**31 + 11):
    """One run of ``cell`` on the CPU with the tiny traffic; its result."""
    args = RUN["parse"](["--workload", cell, "--seed", str(seed),
                         "--seconds", "0", "--trace", "0"])
    files = manifest.cell_files(manifest.load(), cell)
    assert RUN["run"](args, files, torch.device("cpu"), TINY) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def broken(monkeypatch):
    """Patch an entry point of the program with a broken one."""
    def patch(module, name, make):
        monkeypatch.setattr(module, name, make(getattr(module, name)))
    return patch


def test_a_sound_batch_run_is_correct(capsys):
    r = run_cell("default.cold256", capsys)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 8 * 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def test_half_of_the_batch_left_out_is_not_correct(capsys, broken):
    def make(solve):
        def half(gm, scs, cfg, **kw):
            n = len(scs.n_raw) // 2
            res = solve(gm, tree_map(lambda a: a[:n], scs), cfg,
                        **kw)
            return tree_map(lambda a: torch.cat([a, a]), res)
        return half
    broken(pipeline, "solve_batch_jit", make)
    r = run_cell("default.cold256", capsys)
    assert not r["correct"], r["checks"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        capsys, broken):
    def make(solve):
        def altered(*a, **kw):
            res = solve(*a, **kw)
            res.y[:, 40] += 0.5
            return res
        return altered
    broken(pipeline, "solve_batch_jit", make)
    r = run_cell("default.cold256", capsys)
    assert not r["correct"], r["checks"]


def test_a_path_moved_sideways_with_its_offset_is_not_correct(
        capsys, broken):
    """Every knot 0.5 m along the normal and l 0.5 m more: the line l is
    measured from, the bounds and the cost stay; the first knot leaves the
    start."""
    def make(solve):
        def moved(*a, **kw):
            res = solve(*a, **kw)
            h = res.heading - res.d_heading
            res.x.sub_(0.5 * torch.sin(h))
            res.y.add_(0.5 * torch.cos(h))
            res.l.add_(0.5)
            return res
        return moved
    broken(pipeline, "solve_batch_jit", make)
    r = run_cell("default.cold256", capsys)
    assert not r["correct"], r["checks"]
    c = r["checks"]
    assert c["start_m"]["value"] > c["start_m"]["limit"]
    assert c["refline_m"]["value"] <= c["refline_m"]["limit"]


def test_a_query_that_comes_back_not_ok_is_not_correct(capsys, broken):
    """One query of every call not ok: judged whether or not the sample
    holds it."""
    def make(solve):
        def one_lost(*a, **kw):
            res = solve(*a, **kw)
            res.ok[1] = False
            return res
        return one_lost
    broken(pipeline, "solve_batch_jit", make)
    r = run_cell("default.cold256", capsys)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1
    assert r["checks"]["failed"]["value"] == r["failed"]


def test_a_metric_reader_that_loads_jax_leaves_no_result(
        capsys, tmp_path, monkeypatch):
    """A per-layer reader is loaded after the window; one that imports a
    module named ``jax`` (a stub here) makes the run print no result."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    reader = tmp_path / "planted.py"
    reader.write_text("import jax  # noqa: F401\n\n\n"
                      "def read(traced):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    # The traced run's own readings are beside the point here, and slow on
    # the CPU.
    monkeypatch.setattr(port, "profiled_stage_ms", lambda *a: {})
    monkeypatch.setattr(trace, "profile_calls", lambda *a: dict(
        window_s=1.0, busy_s=0.5, device_ops=[], k2_launches=0,
        k2_launch_ms=None))
    args = RUN["parse"](["--workload", "default.single", "--seed", "5",
                         "--seconds", "0", "--trace", "1"])
    files = manifest.cell_files(manifest.load(), "default.single")
    files["metrics"] = {"qp_rounds": reader}
    try:
        rc = RUN["run"](args, files, torch.device("cpu"),
                        dict(TINY, batch=1, pool=4))
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out.out
    assert "jax" in out.err


@pytest.mark.parametrize("cell", ["default.cold256", "default.single"])
def test_the_control_is_not_correct(cell):
    files = manifest.cell_files(manifest.load(), cell)
    traffic = dict(manifest.read(files["traffic"]), sample_per_lane=1)
    got = control.judge_control(manifest.read(files["config"]), traffic,
                                manifest.read(files["limits"]), 31,
                                workers=4)
    assert not got["correct"], got["checks"]


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "default.single",
         "--seed", "7", "--seconds", "3", "--trace", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert np.isfinite(r["metrics"]["stage_ms.bounds"]["value"])
