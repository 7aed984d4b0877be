"""The port's remaining entry points on the CPU: the CLI
(``tpu_pathopt_torch.cli``), the scalar path-QP solver and its trace
(``path_solver.solve_path_qp``, ``trace_path_rounds``) against the JAX
package's, and the native host ESDF (``runtime.native``) against the JAX
package's and the port's device EDT.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import test_torch_qp as tq
from tpu_pathopt import maps as jmaps
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt.qp.admm import QPSettings as JaxSettings
from tpu_pathopt.runtime import native as jnative
from tpu_pathopt.solver import assembly as jassembly
from tpu_pathopt.solver import path_solver as jpath_solver
from tpu_pathopt_torch import cli, maps
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.runtime import native
from tpu_pathopt_torch.solver import assembly, path_solver

N = tq.N
CHECK = QPSettings().check_every


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    png = tmp_path_factory.mktemp("cli") / "demo.png"
    text = run_cli(["--synthetic", "--small", "--cpu", "--profile",
                    "--verbose-qp", "--out", str(png)])
    return text, png


def test_cli_solves_the_demo_and_writes_a_png(cli_run):
    text, png = cli_run
    assert "device: cpu" in text
    assert "solve: ok=True" in text
    assert f"wrote {png}" in text
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_profile_prints_the_stage_times(cli_run):
    text, _ = cli_run
    for stage in ("prep", "smooth", "corridor", "post_smooth", "geometry",
                  "path_qp", "finalize"):
        assert f"  {stage}: " in text, stage
    assert "[pipeline] total" in text


def test_cli_verbose_qp_prints_a_converged_trace(cli_run):
    text, _ = cli_run
    lines = text.splitlines()
    i = lines.index("path QP pass 1, per-round residuals "
                    "(OSQP verbose equivalent):")
    rows = lines[i + 2:]
    assert rows[0].split()[0] == "25"
    assert any(r.endswith("converged") for r in rows)
    assert "trace truncated" not in text


def test_cli_without_matplotlib_says_no_png(tmp_path, monkeypatch):
    real = cli.importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    png = tmp_path / "none.png"
    text = run_cli(["--synthetic", "--small", "--cpu", "--out", str(png)])
    assert "solve: ok=True" in text
    assert f"matplotlib is not installed: no PNG written to {png}" in text
    assert not png.exists()


# ----------------------- the scalar solver and its trace ---------------------

def path_qps(dtype):
    """test_torch_qp's four path QPs in both packages, in ``dtype``; in
    float64 the JAX end-row index is widened to match the 64-bit literals
    of its dynamic_slice under x64."""
    inp = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
           for k, v in tq.path_inputs().items()}
    qp_j = jax.vmap(lambda d: jassembly.assemble_path_qp(
        **d, config=JaxConfig(n_knots=N)))(
        {k: jnp.asarray(v) for k, v in inp.items()})
    if dtype == np.float64:
        qp_j = qp_j.replace(end_idx=qp_j.end_idx.astype(jnp.int64))
    qp = assembly.assemble_path_qp(
        **{k: torch.as_tensor(v) for k, v in inp.items()},
        config=PlannerConfig(n_knots=N))
    return qp_j, qp


def test_solve_path_qp_matches_jax():
    """The scalar solver (factors not inverted, every round refactored)
    against the JAX package's, vmapped: the same flags, iterations within
    one check interval, v within the 2e-3 termination tolerance's 5e-3."""
    qp_j, qp = path_qps(np.float32)
    want = jax.vmap(lambda q: jpath_solver.solve_path_qp(
        q, settings=JaxSettings()))(qp_j)
    got = path_solver.solve_path_qp(qp)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= CHECK
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=5e-3)
    assert got.rounds == int(got.iters.max()) // CHECK


def test_trace_path_rounds_matches_jax():
    """8 rounds of the trace in float64 against the JAX package's, at
    tests/test_admm_trace.py's tolerances for an adaptive-rho trajectory:
    the same iteration counts and convergence flags, the same refactor
    decisions, rho_bar to 5e-3 relative, on the rounds before a scenario
    converges (after it the trace holds its values)."""
    with jax.enable_x64(True):
        qp_j, qp = path_qps(np.float64)
        assert qp.p_diag.dtype == torch.float64
        want = jax.vmap(lambda q: jpath_solver.trace_path_rounds(
            q, JaxSettings(), n_rounds=8, rho0=0.1))(qp_j)
        want = {k: np.asarray(v).T for k, v in want.items()}
    got = {k: v.numpy() for k, v in path_solver.trace_path_rounds(
        qp, QPSettings(), n_rounds=8, rho0=0.1).items()}
    assert got["iters"].shape == (8, 4)
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["rho_bar"], want["rho_bar"], rtol=5e-3)
    changed = lambda r: np.abs(np.diff(np.log(r), axis=0)) > 1e-12  # noqa
    np.testing.assert_array_equal(changed(got["rho_bar"]),
                                  changed(want["rho_bar"]))
    live = ~want["converged"]
    np.testing.assert_allclose(got["pri_res"][live], want["pri_res"][live],
                               rtol=2e-2)
    np.testing.assert_allclose(got["dua_res"][live], want["dua_res"][live],
                               rtol=2e-2)
    sol = path_solver.solve_path_qp(qp, rho0=0.1)
    done = want["converged"][-1]
    np.testing.assert_array_equal(got["iters"][-1][done],
                                  sol.iters.numpy()[done])


# ------------------------------- native ESDF ---------------------------------

def test_native_esdf_matches_scipy():
    if not native.available():
        pytest.skip("no C++ compiler")
    rng = np.random.default_rng(0)
    mask = rng.random((120, 90)) < 0.03
    mask[0, 0] = True
    np.testing.assert_allclose(native.esdf_pixels(mask),
                               scipy.ndimage.distance_transform_edt(~mask),
                               atol=1e-3)


def test_native_build_map_matches_jax_and_the_device_edt():
    rng = np.random.default_rng(1)
    mask = rng.random((64, 64)) < 0.05
    mask[3, 3] = True
    got = native.build_map_native(mask, resolution=0.5, device="cpu")
    assert got.esdf.device.type == "cpu" and (got.n_rows, got.n_cols) == \
        (64, 64)
    want = jnative.build_map_native(mask, resolution=0.5)
    np.testing.assert_allclose(got.esdf.numpy(), np.asarray(want.esdf),
                               atol=1e-3)
    np.testing.assert_allclose(
        got.esdf.numpy(),
        maps.build_map(mask, resolution=0.5, device="cpu").esdf.numpy(),
        atol=1e-3)
    np.testing.assert_allclose(
        got.esdf.numpy(),
        np.asarray(jmaps.build_map(jnp.asarray(mask), resolution=0.5).esdf),
        atol=1e-3)
