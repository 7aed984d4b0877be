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
    out of sys.modules, and so do matplotlib and PIL (the card's machine
    has neither: viz and the CLI import them where they draw or read a
    PNG), and no kernel library is built or loaded."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from tpu_pathopt_torch import kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_pathopt', 'triton', 'bench', "
        "'matplotlib', 'PIL'))\n"
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


def test_replanning_and_variant_entry_points_need_cuda_too():
    """The entry points of the replanning loop and of the second
    configuration raise without a GPU unless told device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from tpu_pathopt_torch import collision, replan
    gm, scs, _ = scenarios.build_adversarial(4, device="cpu")
    cfg = PlannerConfig()
    calls = [lambda: pipeline.solve_batch_warm(gm, scs, cfg),
             lambda: pipeline.solve_batch_profiled(gm, scs, cfg),
             lambda: replan.replan_stream(gm, scs, cfg, n_steps=1),
             lambda: pipeline.QPWarmStart.cold(4, cfg),
             lambda: collision.make_car_geometry(cfg)]
    calls += [lambda kw=kw: pipeline.solve_batch(gm, scs, PlannerConfig(**kw))
              for kw in (dict(smoothing_method="TENSION"),
                         dict(corridor_method="ASTAR"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_fleet_cli_and_native_entry_points_need_cuda_too():
    """The sharded fleet path, the CLI without --cpu and the native map
    loader raise without a GPU unless told the CPU; init_distributed raises
    before it contacts any coordinator."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import numpy as np_
    from tpu_pathopt_torch import cli, dist, replan
    from tpu_pathopt_torch.runtime import native
    gm, scs, _ = scenarios.build_adversarial(4, device="cpu")
    cfg = PlannerConfig()
    cpu_mesh = dist.make_mesh(device="cpu")
    calls = [lambda: dist.make_mesh(),
             lambda: dist.init_distributed("127.0.0.1:1", num_processes=2,
                                           process_id=0),
             lambda: dist.solve_sharded(gm, scs, cfg, dist.Mesh(
                 0, 1, torch.device("cuda"))),
             lambda: replan.replan_stream_sharded(
                 gm, scs, cfg, dist.Mesh(0, 1, torch.device("cuda")),
                 n_steps=1),
             lambda: cli.main(["--synthetic", "--small"]),
             lambda: native.build_map_native(np_.zeros((8, 8), bool))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert cpu_mesh.device.type == "cpu"


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


def test_dense_solver_and_smoothers_stay_on_their_inputs_device():
    """The dense solver, its tracer and the single-scenario smoothers
    compute where their inputs lie and in their dtype: CPU inputs give CPU
    outputs (nothing goes to the card and back), float64 stays float64,
    and the inputs are left as they were."""
    import tpu_pathopt_torch.smoothing.post_smooth as post_mod
    import tpu_pathopt_torch.smoothing.tension2 as t2_mod
    from tpu_pathopt_torch import maps
    from tpu_pathopt_torch.qp import admm
    from tpu_pathopt_torch.smoothing import tension
    from tpu_pathopt_torch.torchutil import tree_leaves

    rng = np.random.default_rng(0)
    F = rng.normal(size=(6, 6))
    A = rng.normal(size=(4, 6))
    qp64 = [torch.tensor(a) for a in (F @ F.T + np.eye(6), rng.normal(
        size=6), A, -np.ones(4), np.ones(4))]
    M = 12
    u = np.linspace(0.0, 1.0, M)
    x, y = 10.0 * u - 5.0, np.sin(u)
    ang = np.arctan2(np.gradient(y), np.gradient(x))
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    pts = [torch.tensor(a, dtype=torch.float32) for a in (x, y, ang,
                                                          np.gradient(ang), s)]
    layers = [torch.linspace(0.0, 20.0, 8), -torch.ones(8), torch.ones(8),
              torch.tensor(0.2)]
    gm = maps.build_map(np.zeros((80, 80), bool), device="cpu")
    cfg = PlannerConfig()
    calls = {
        "solve_qp": (lambda: admm.solve_qp(*qp64), torch.float64),
        "solve_qp_batched": (lambda: admm.solve_qp_batched(
            *(a[None] for a in qp64)), torch.float64),
        "trace_rounds": (lambda: admm.trace_rounds(*qp64, n_rounds=2),
                         torch.float64),
        "tension2_smooth": (lambda: t2_mod.tension2_smooth(
            *pts, torch.tensor(M - 2), cfg), torch.float32),
        "post_smooth": (lambda: post_mod.post_smooth(
            *layers, torch.tensor(6), cfg), torch.float32),
        "tension_smooth": (lambda: tension.tension_smooth(
            gm, *pts[:3], torch.tensor(M - 2), cfg), torch.float32),
    }
    inputs = qp64 + pts + layers
    before = [a.clone() for a in inputs]
    for name, (call, dtype) in calls.items():
        out = call()
        leaves = tree_leaves(out) if not isinstance(out, dict) else list(
            out.values())
        assert leaves and all(t.device.type == "cpu" for t in leaves), name
        assert all(t.dtype == dtype for t in leaves
                   if t.is_floating_point()), name
    for a, b in zip(inputs, before):
        assert a.device.type == "cpu" and torch.equal(a, b)
