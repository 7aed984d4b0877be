"""The least work of the DP corridor search's edges
(``h100_bench/metrics/_work_dp.py``), counted from the lattice's shape
alone, and the two per-layer readers built on it and on the corridor
stage's spans: ``corridor_ms.edges_dp`` and ``roofline_pct.dp_edges``."""

import pytest

from h100_bench.core import manifest
from h100_bench.metrics import _work, _work_dp

READERS = ("corridor_ms.edges_dp", "roofline_pct.dp_edges")


def reader(name):
    return manifest.module(manifest.HERE / "metrics" / f"{name}.py").read


def test_the_work_at_a_small_lattice_is_the_hand_count():
    b, layers, k = 2, 3, 4
    nodes = b * (layers + 1) * k                        # 32
    want_bytes = (2 * nodes * 4                         # node x, y: 256
                  + b * layers * 4                      # headings: 24
                  + b * layers * k * 5                  # self cost, feasible
                  + b * (layers + 1) * 4                # layer s: 32
                  + 2 * b * k * 4                       # cost0, dir0: 64
                  + b * layers * k * 8 + b * layers)    # costs, parents, alive
    assert want_bytes == 694
    assert _work_dp.ATAN2_FLOPS == 20 and _work_dp.EDGE_FLOPS == 43
    assert _work_dp.work(b, layers, k) == (694, 2 * 3 * 16 * 43)


@pytest.mark.parametrize("k", [35, 135, 300])
def test_operations_scale_as_k_squared_and_bytes_as_k(k):
    def at(kk):
        return _work_dp.work(256, 31, kk)
    (b1, f1), (b2, f2), (b3, f3) = at(k), at(2 * k), at(3 * k)
    assert f2 == 4 * f1 and f3 == 9 * f1
    assert b3 - b2 == b2 - b1 > 0           # affine in K: no K^2 term
    assert b1 < 2 * (b2 - b1)               # the K-free part is small


def test_the_fine_lattice_is_bound_by_its_operations():
    ms, by = _work_dp.bound_ms(256, 31, 135)
    assert by == "operations"
    assert ms == pytest.approx(256 * 31 * 135 ** 2 * 43
                               / _work.FP32_FLOPS_PER_S * 1e3)


def test_the_readers_read_the_corridor_parts_and_the_lattice():
    summary = dict(corridor_ms=dict(nodes=1.0, edges=6.0, dp_forward=0.8,
                                    finish=0.5, edges_dp=6.8),
                   work=dict(lattice=dict(shape=[256, 31, 135])))
    traced = {"incall": summary}
    assert reader("corridor_ms.edges_dp")(traced) == 6.8
    bound, _ = _work_dp.bound_ms(256, 31, 135)
    assert reader("roofline_pct.dp_edges")(traced) == pytest.approx(
        100.0 * bound / 6.8)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("summary", [
    None,                                       # nothing read
    {},                                         # no traced call
    dict(stage_ms=dict(corridor=6.9), qp_loop_ms=11.9),   # the parent's
    dict(corridor_ms=None, work={}),            # a key with no DP search
])
def test_the_readers_read_nothing_without_the_corridor_parts(name, summary):
    assert reader(name)({"incall": summary}) is None
