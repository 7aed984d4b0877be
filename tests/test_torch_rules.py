"""Rules of the port (``tpu_pathopt_torch``) that hold whatever it computes:

- it imports neither JAX, Flax nor the JAX package, by its import graph and
  by its source text, and imports on a machine with no GPU, no ``nvcc`` and
  no ``triton``, building nothing at import;
- its entry points run on ``cuda`` unless told otherwise, and raise rather
  than fall back to the CPU;
- its configuration classes have the JAX classes' fields, defaults and
  validation;
- its adversarial batch (``scenarios.py``) is ``bench.build_adversarial``'s.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp.admm import INFTY as JAX_INFTY
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt_torch import pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp.admm import INFTY, QPSettings

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpu_pathopt_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathopt", "bench")


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_every_port_module_imports_without_jax_gpu_nvcc_or_triton():
    """A fresh interpreter imports every module of the port with PATH and
    CUDA_HOME pointing nowhere; JAX, Flax, the JAX package and triton stay
    out of sys.modules and no kernel library is built or loaded."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from tpu_pathopt_torch import kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_pathopt', 'triton', 'bench'))\n"
        "print(json.dumps(dict(n=len(mods), bad=bad, "
        "lib=kernels._lib is not None)))\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               CUDA_PATH="/nonexistent", PYTHONPATH=str(ROOT))
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == dict(n=len(port_modules()), bad=[], lib=False)
    assert res["n"] >= 25


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_need_cuda_unless_told_otherwise():
    """With no GPU, a call without device="cpu" raises instead of running
    on the CPU; with device="cpu" it runs there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    gm, scs, _ = scenarios.build_adversarial(4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.solve_batch(gm, scs, PlannerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        scenarios.build_adversarial(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.solve(gm, dataclasses.replace(
            scs, **{f.name: getattr(scs, f.name)[0]
                    for f in dataclasses.fields(scs)}), PlannerConfig())


def field_defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("pair", ["config", "settings"])
def test_config_classes_match_jax_field_for_field(pair):
    ours, theirs = ((PlannerConfig, JaxConfig) if pair == "config"
                    else (QPSettings, JaxSettings))
    assert list(field_defaults(ours).items()) == \
        list(field_defaults(theirs).items())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours(), dataclasses.fields(ours)[0].name, None)


def test_config_validation_and_derived_values_match_jax():
    assert INFTY == JAX_INFTY
    assert PlannerConfig().kappa_limit == JaxConfig().kappa_limit
    kw = dict(qp_max_iter=500, qp_eps_abs=1e-3)
    assert dataclasses.asdict(PlannerConfig(**kw).qp_settings(alpha=1.5)) \
        == dataclasses.asdict(JaxConfig(**kw).qp_settings(alpha=1.5))
    for bad in (dict(smoothing_method="SPLINE"),
                dict(corridor_method="RRT")):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            PlannerConfig(**bad)
    assert hash(PlannerConfig()) == hash(PlannerConfig())


@pytest.mark.parametrize("batch", [8, 256])
def test_scenarios_equal_bench_build_adversarial(batch):
    gm, scs, n = bench.build_adversarial(batch)
    arr = scenarios.adversarial_arrays(batch)
    assert n == batch // 4
    np.testing.assert_array_equal(arr["raw_x"], np.asarray(scs.raw_x))
    np.testing.assert_array_equal(arr["raw_y"], np.asarray(scs.raw_y))
    np.testing.assert_array_equal(arr["n_raw"], np.asarray(scs.n_raw))
    for i, name in enumerate(("x", "y", "heading")):
        np.testing.assert_array_equal(arr["start"][:, i],
                                      np.asarray(getattr(scs, "start_" + name)))
        np.testing.assert_array_equal(
            arr["target"][:, i], np.asarray(getattr(scs, "target_" + name)))
    np.testing.assert_array_equal(np.asarray(scs.start_k), 0.0)
    # Obstacle cells are exactly those at ESDF distance 0.
    esdf = np.asarray(gm.esdf)
    mask = scenarios.adversarial_mask()
    assert (gm.n_rows, gm.n_cols) == mask.shape == (scenarios.SIZE,) * 2
    assert esdf.shape == scenarios.PAD_SHAPE == bench.PAD_SHAPE
    np.testing.assert_array_equal(mask, esdf[:300, :300] == 0.0)
    assert scenarios.R_RAW == bench.R_RAW
    sc = scenarios.scenario_batch(arr, device="cpu")
    np.testing.assert_array_equal(sc.raw_x.numpy(), np.asarray(scs.raw_x))
    assert sc.n_raw.dtype == torch.int64


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero with no result line on a machine with
    no GPU, and alone in a directory (without the package)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
