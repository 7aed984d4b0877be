"""ms of the ``bounds`` stage (reference line, splines, collision bounds,
geometry) inside the timed compiled call: the program's device stamps at
the ``bounds`` and ``path_qp`` boundaries of its graph, the mean over the
traced calls of ``_incall``. Unlike ``stage_ms.bounds``, no wait between
stages is in it."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "stage_ms", "bounds")
