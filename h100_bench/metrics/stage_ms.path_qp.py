"""ms of the ``path_qp`` stage (assembly and both passes of the path QP):
the mean over the traced run's calls of ``pipeline.solve_batch_profiled``
on the cell's own traffic, each stage its own compiled call."""


def read(traced: dict):
    return traced.get("stage_ms", {}).get("path_qp")
