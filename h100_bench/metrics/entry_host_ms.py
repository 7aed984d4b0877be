"""Host ms a call spends inside the program's compiled entry
(``pipeline.compiled_call``: signature and key, input copy, graph launch,
result clone): its ``entry`` span, the mean over the traced calls of
``_incall``."""

from h100_bench.metrics import _incall


def read(traced: dict):
    return _incall.value(traced, "entry_ms", "entry")
