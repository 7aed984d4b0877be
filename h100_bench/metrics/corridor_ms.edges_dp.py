"""ms of the DP corridor search's edges inside the timed compiled call:
the edge costs (``prepare_lattice``'s K x K edge tables) and the forward
pass over them (K4), from the program's device stamps inside its corridor
stage, the mean over the traced calls of ``_incall``. Nothing where the
program has no such stamps."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "corridor_ms", "edges_dp")
