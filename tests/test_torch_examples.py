"""Smoke test for examples/quickstart_torch.py, the port's walkthrough: it
must keep working as the API evolves (build_map, the Scenario batch,
solve_batch, solve_batch_warm + advance_scenarios and viz.plot_result, end
to end). Here it runs with ``--device cpu``; ``chip_smoke.py``'s ``cli``
phase runs it on the card."""

import importlib.util
import os
import runpy
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_torch_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    out_png = tmp_path / "quickstart.png"
    monkeypatch.setattr(sys, "argv", ["quickstart_torch.py", "--device",
                                      "cpu", "--out", str(out_png)])
    runpy.run_path(os.path.join(_ROOT, "examples", "quickstart_torch.py"),
                   run_name="__main__")
    text = capsys.readouterr().out
    assert "solved 8 scenarios: ok=8/8" in text
    assert "replanned (warm): ok=8/8" in text
    if importlib.util.find_spec("matplotlib") is None:
        assert "no PNG written" in text
    else:
        assert out_png.exists() and out_png.stat().st_size > 0
