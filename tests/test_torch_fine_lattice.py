"""The benchmark's fine-lattice cell (``fine_lattice.cold256``: the DP
corridor at 0.15 m, 135 laterals) run whole on the CPU at a tiny size, as
``h100_bench/tests/test_h100_runs.py`` runs the default cells: the port's
compiled entry (``pipeline.solve_batch_jit``, whose plain chain takes
``corridor.dp_forward_plain`` at 135 laterals) judged against the
harness's float64 reference under the cell's limits. Sound, it comes out
correct; with every answer moved sideways, not.

This process has loaded JAX (``tests/conftest.py``, for the JAX package's
own tests), which a benchmark run refuses; the run's own check of that is
held in ``h100_bench/tests``, so here it is set aside."""

import json
import math
import runpy

import pytest
import torch

from h100_bench.core import manifest
from tpu_pathopt_torch import pipeline

CELL = "fine_lattice.cold256"
RUN = runpy.run_path(str(manifest.HERE / "run.py"), run_name="bench_run")
TINY = {"batch": 8, "pool": 1, "sample_per_lane": 1}


@pytest.fixture
def run_cell(capsys, monkeypatch):
    monkeypatch.setitem(RUN["run"].__globals__, "forbidden_modules",
                        lambda: [])

    def run(seed=2**31 + 18):
        args = RUN["parse"](["--workload", CELL, "--seed", str(seed),
                             "--seconds", "0", "--trace", "0"])
        files = manifest.cell_files(manifest.load(), CELL)
        assert RUN["run"](args, files, torch.device("cpu"), TINY) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return run


def test_the_cell_is_the_default_with_the_fine_lattice():
    files = manifest.cell_files(manifest.load(), CELL)
    conf = manifest.read(files["config"])
    default = manifest.read(manifest.HERE / "configs" / "default.json")
    assert conf["planner"] == {"search_lateral_spacing": 0.15,
                               "dp_laterals": 135}
    assert math.ceil(2 * 10.0 / 0.15) + 1 == 135
    same = ("dtype", "map", "resolution", "pad_shape", "route_x",
            "reduced", "guarantees")
    assert {k: conf[k] for k in same} == {k: default[k] for k in same}
    assert files["traffic"].name == "cold256.json"


def test_a_sound_run_of_the_fine_lattice_is_correct(run_cell):
    r = run_cell()
    assert r["correct"], r["checks"]
    assert r["attempted"] == 8 and r["failed"] == 0


def test_answers_moved_sideways_are_not_correct(run_cell, monkeypatch):
    """Every knot 0.3 m along the normal and l 0.3 m more: the first knot
    leaves the start pose."""
    solve = pipeline.solve_batch_jit

    def moved(*a, **kw):
        res = solve(*a, **kw)
        h = res.heading - res.d_heading
        res.x.sub_(0.3 * torch.sin(h))
        res.y.add_(0.3 * torch.cos(h))
        res.l.add_(0.3)
        return res
    monkeypatch.setattr(pipeline, "solve_batch_jit", moved)
    r = run_cell()
    assert not r["correct"], r["checks"]
    c = r["checks"]["start_m"]
    assert c["value"] > c["limit"]
