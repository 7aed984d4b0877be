"""ms of the DP corridor search's lattice inside the timed compiled call:
the corridor stage from its start to the edge costs (the refit of the
smoothed route, the vehicle's projection, the layers, the nodes with their
clearance, feasibility and rough bounds), from the program's device stamps
inside its corridor stage, the mean over the traced calls of ``_incall``.
Nothing where the program has no such stamps."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "corridor_ms", "nodes")
