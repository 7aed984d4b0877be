"""Batch-wide properties of the port's solutions on the adversarial mix:
the counterparts of ``tests/test_properties.py``, at B = 8 (two scenarios
each of the easy, tight, slalom and blocked lanes) at the default
configuration, on the CPU.

The solutions satisfy what the QP encodes: |kappa| within the steering
limit (base_solver.cpp:226-231) up to the solver's 2e-3 tolerance plus
float32 headroom (5e-3), the axle points within the hard corridor up to
5e-2 (the slack relaxes only the soft shrink, :232-248), collision-free
paths (>= 95% of the valid knots under the six-circle footprint), blocked
lanes truncated before the wall; and each scenario's outputs do not depend
on its place in the batch, which the pipeline sorts twice (stable
``argsort``) and scatters back: equal bit for bit under a permutation.
"""

import numpy as np
import pytest
import torch

from tpu_pathopt_torch import collision, golden, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.torchutil import tree_map

CFG = PlannerConfig()


@pytest.fixture(scope="module")
def mixed_batch():
    gm, scs, n_lane = scenarios.build_adversarial(8, device="cpu")
    return gm, scs, pipeline.solve_batch(gm, scs, CFG, device="cpu"), n_lane


def test_mixed_batch_converges_and_blocked_lane_truncates(mixed_batch):
    _, _, res, n_lane = mixed_batch
    assert bool(res.ok.all())
    blocked = res.blocked.numpy()
    assert blocked[3 * n_lane:].all() and not blocked[:3 * n_lane].any()
    nv = res.n_valid.numpy()
    assert (nv[3 * n_lane:] < nv[:n_lane].min()).all()
    for b in range(3 * n_lane, 4 * n_lane):
        assert float(res.x[b, :nv[b]].max()) < 10.5   # the wall at x = 10


def test_curvature_within_steering_limit(mixed_batch):
    _, _, res, _ = mixed_batch
    k = torch.where(res.mask, res.k.abs(), 0.0)
    assert float(k.max()) <= CFG.kappa_limit + 5e-3


def test_path_within_soft_collision_corridor(mixed_batch):
    _, _, res, _ = mixed_batch
    cb, m = res.bounds, res.mask
    for length, lb, ub in ((CFG.front_length, cb.front_lb, cb.front_ub),
                           (CFG.rear_length, cb.rear_lb, cb.rear_ub)):
        pos = res.l + length * res.d_heading
        assert bool(((pos <= ub + 5e-2) | ~m).all())
        assert bool(((pos >= lb - 5e-2) | ~m).all())


def test_path_is_collision_free(mixed_batch):
    gm, _, res, _ = mixed_batch
    car = collision.make_car_geometry(CFG, "cpu")
    for b in range(len(res.ok)):
        one = tree_map(lambda a: a[b], res)
        frac = float(collision.path_collision_free(gm, car, one))
        assert frac >= 0.95, f"scenario {b}: only {frac:.2f} collision-free"


def test_batch_permutation_invariance(mixed_batch):
    gm, scs, res, _ = mixed_batch
    perm = torch.as_tensor(np.random.default_rng(11).permutation(8))
    inv = torch.argsort(perm)
    res_p = pipeline.solve_batch(gm, tree_map(lambda a: a[perm], scs), CFG,
                                 device="cpu")
    for name in golden.PATH_FIELDS + golden.FLAG_FIELDS + \
            golden.COUNT_FIELDS:
        assert torch.equal(getattr(res, name), getattr(res_p, name)[inv]), \
            name
