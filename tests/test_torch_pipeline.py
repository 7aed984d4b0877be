"""The port's pipeline end to end against the JAX package's.

The golden fixture ``tpu_pathopt_torch/testdata/jax_adversarial_b8.npz`` is
the JAX ``solve_batch`` result on ``bench.build_adversarial(8)`` at the
default config; :func:`write_golden` writes it::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \
import test_torch_pipeline as t; t.write_golden()"

One test regenerates it from the JAX package and compares it with the stored
file; another holds the port (on the CPU) against the stored file, as
``chip_smoke.py`` holds the card against it. Tolerances: ``golden.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
from tpu_pathopt import pipeline as jpipe
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import golden, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig


def jax_golden_arrays() -> dict:
    """The JAX package's solve_batch on the golden batch, as flat arrays."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    res = jpipe.solve_batch_jit(gm, scs, JaxConfig())
    return golden.arrays(jax.tree_util.tree_map(np.asarray, res))


def write_golden():
    """(Re)write the stored fixture from the JAX package."""
    np.savez_compressed(golden.FIXTURE, **jax_golden_arrays())


@pytest.fixture(scope="module")
def port_result():
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    return pipeline.solve_batch(gm, scs, PlannerConfig(), device="cpu")


def test_golden_fixture_regenerates():
    want = golden.load()
    got = jax_golden_arrays()
    assert set(got) == set(want)
    failures, _ = golden.compare(got, want)
    assert not failures, failures
    # The JAX package is the reference: its flags and counts reproduce
    # exactly, its values to float32 round-off across machines.
    for f in golden.FLAG_FIELDS + golden.COUNT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in golden.PATH_FIELDS:
        np.testing.assert_allclose(got[f], want[f], atol=1e-3, err_msg=f)


def test_port_matches_golden_on_cpu(port_result):
    want = golden.load()
    assert bool(want["ok"].all())
    failures, diffs = golden.compare(golden.arrays(port_result), want)
    assert not failures, (failures, diffs)


def test_port_result_shapes_and_flags(port_result):
    res = port_result
    B, N = golden.BATCH, PlannerConfig().n_knots
    for f in golden.PATH_FIELDS:
        t = getattr(res, f)
        assert t.shape == (B, N) and t.dtype == torch.float32, f
        assert torch.isfinite(t[res.mask]).all(), f
    assert bool(res.ok.all())
    # Two per lane, lanes in order: only the blocked lane is blocked.
    assert res.blocked.tolist() == [False] * 6 + [True] * 2


def test_solve_matches_batch_element(port_result):
    """The single-scenario entry point is a batch of one."""
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device="cpu")
    i = 4
    sc = pipeline.Scenario(**{f.name: getattr(scs, f.name)[i]
                              for f in dataclasses.fields(scs)})
    one = pipeline.solve(gm, sc, PlannerConfig(), device="cpu")
    assert int(one.n_valid) == int(port_result.n_valid[i])
    assert bool(one.ok) == bool(port_result.ok[i])
    np.testing.assert_allclose(one.l.numpy(), port_result.l[i].numpy(),
                               atol=1e-4)


def test_slalom_lane_is_this_sensitive_in_the_jax_package_itself():
    """Why the end-to-end tolerances are loose: a relative 1e-7 change of
    the raw points (one float32 ulp) moves the JAX package's own slalom
    result by centimetres and its ADMM count by an interval, while the easy
    lane stays at float32 round-off. The port differs from the fixture by
    about as much, for the same reason."""
    gm, scs, _ = bench.build_adversarial(golden.BATCH)
    base = golden.load()
    moved = scs.replace(raw_x=scs.raw_x * (1 + 1e-7),
                        raw_y=scs.raw_y * (1 + 1e-7))
    got = golden.arrays(jax.tree_util.tree_map(
        np.asarray, jpipe.solve_batch_jit(gm, moved, JaxConfig())))
    failures, diffs = golden.compare(got, base)
    assert not failures, failures
    m = np.arange(got["x"].shape[-1])[None] < base["n_valid"][:, None]
    dx = np.abs(np.where(m, got["x"] - base["x"], 0)).max(axis=1)
    assert dx[4:6].max() > 1e-2        # slalom lane: centimetres
    assert dx[:2].max() < 1e-3         # easy lane: round-off
