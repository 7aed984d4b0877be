"""ms of the ``bounds`` stage (reference line, splines, collision bounds,
geometry): the mean over the traced run's calls of
``pipeline.solve_batch_profiled`` on the cell's own traffic, each stage its
own compiled call."""


def read(traced: dict):
    return traced.get("stage_ms", {}).get("bounds")
