"""% of the traced window in which no graph replay is in flight on the
stream: one less the summed device spans of every ``CUDAGraph.replay``
(CUDA events around each) over the window. Gaps between kernels inside a
graph count as busy, so this is a lower bound of the device's idle share."""


def read(traced: dict):
    spans, window = traced.get("spans_ms"), traced.get("window_s")
    if not spans or not window:
        return None
    return 100.0 * (1.0 - sum(spans) / 1e3 / window)
