"""BENCHMARK.json keeps to the benchmark's contract, and every file a cell
uses is found by the names the manifest gives it."""

import json
import re

import pytest

from h100_bench.core import manifest

MAN = manifest.load()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "h100_bench/run.py"]
    assert MAN["paths"] == ["h100_bench"]
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    names = [c["name"] for c in MAN["configs"]] + CELLS + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_one_line_fields():
    texts = [w["why"] for w in MAN["workloads"]] + [
        c["source"] for c in MAN["configs"]] + [
        m["layer"] for m in MAN["per_layer"]] + MAN["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"solves_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_solves_per_s_in_cells_that_exist():
    for m in MAN["per_layer"]:
        assert m["moves"] == "solves_per_s"
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_run_seconds_fits_the_check_with_24_cells():
    s = MAN["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_runs_on_one_chip():
    assert all(w["chips"] == 1 for w in MAN["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    files = manifest.cell_files(MAN, cell)
    for role in ("config", "traffic", "driver", "limits"):
        assert files[role].is_file(), (role, files[role])
    for path in files["metrics"].values():
        assert path.is_file(), path
    conf = json.loads(files["config"].read_text())
    assert {"source", "planner", "map", "dtype", "assumed",
            "reduced"} <= set(conf)
    limits = json.loads(files["limits"].read_text())
    assert limits["flags"] == 0
    for path in files["metrics"].values():
        assert callable(manifest.module(path).read), path


def test_config_files_match_the_manifest():
    for c in MAN["configs"]:
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
