"""Graph nodes one call executes: the top-level nodes of the timed graph
plus each conditional body's nodes times the rounds or refactors it ran in
the call, the program's stamps left out (counted as the traced key is
captured, ``cudaGraphGetNodes``), the mean over the traced calls of
``_incall``."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "graph_nodes")
