"""``BENCHMARK.json`` and the files it names. Every file of a cell is found
by a name the manifest gives it:

- ``configs/<config>.json`` (the configuration's ``file``),
- ``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``,
- ``limits/<cell>.json``, the limits ``correct`` holds the cell's numbers to,
- ``metrics/<metric>.py`` for each per-layer metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent   # h100_bench/
ROOT = HERE.parent                              # the checkout


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def module(path: Path):
    """The Python file at ``path``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "h100_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell_files(man: dict, name: str, root: Path = ROOT) -> dict:
    """Every file cell ``name`` uses, by role; raises KeyError for a cell
    the manifest does not hold."""
    cell = {w["name"]: w for w in man["workloads"]}[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    traffic = HERE / "traffic" / f"{cell['traffic']}.json"
    return dict(
        cell=cell, config=root / conf["file"], traffic=traffic,
        driver=HERE / "drivers" / f"{read(traffic)['driver']}.py",
        limits=HERE / "limits" / f"{name}.json",
        metrics={m["name"]: HERE / "metrics" / f"{m['name']}.py"
                 for m in man["per_layer"] if applies(m, name)},
        end_to_end=[m for m in man["end_to_end"] if applies(m, name)])
