"""Device ms a call spends inside the WHILE nodes of its four QP solves
(smoothing, post-smoothing, both path-QP passes): the program's stamps just
before and just after each node, summed over the four, the mean over the
traced calls of ``_incall``. Read it beside ``qp_rounds``."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "qp_loop_ms")
