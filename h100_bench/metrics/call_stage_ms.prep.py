"""ms of the ``prep`` stage (the B-spline fit of the raw points and the 1 m
segmentation) inside the timed compiled call: the program's device stamps
at the ``prep`` and ``smooth`` boundaries of its graph, the mean over the
traced calls of ``_incall``."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "stage_ms", "prep")
