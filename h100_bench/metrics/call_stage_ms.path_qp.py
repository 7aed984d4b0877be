"""ms of the ``path_qp`` stage (assembly and both passes of the path QP)
inside the timed compiled call: the program's device stamps at the
``path_qp`` and ``finalize`` boundaries of its graph, the mean over the
traced calls of ``_incall``. Unlike ``stage_ms.path_qp``, no wait between
stages is in it."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "stage_ms", "path_qp")
