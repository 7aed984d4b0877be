"""The DP edges' share of their roofline, in %: the least time the edge
costs and the forward pass over them could take (``_work_dp``, from the
lattice's shape the program notes: the larger of its bytes over 3.35 TB/s
and its float operations over 67 TFLOP/s) over ``corridor_ms.edges_dp``.
Nothing where either is not read."""

from h100_bench.metrics import _incall, _work_dp


def read(traced: dict):
    ms = _incall.value(traced, "corridor_ms", "edges_dp")
    shape = _incall.value(traced, "work", "lattice", "shape")
    if ms is None or shape is None:
        return None
    bound, _ = _work_dp.bound_ms(*shape)
    return 100.0 * bound / ms
