"""K2's share of its roofline, in %: the least time one launch could take
(the larger of its bytes over 3.35 TB/s and its float operations over
67 TFLOP/s, from its shapes) over the mean device time of the K2 launches
the profiler's trace of the compiled call shows. A mean over launches stays
sound where the trace misses some runs of a conditional node's body.
Nothing when the trace shows no K2 launch."""

from h100_bench.metrics import _work


def read(traced: dict):
    k2 = traced.get("k2")
    if not k2 or not k2.get("launch_ms"):
        return None
    bound, _ = _work.bound_ms("fused_admm_round", _work.admm_round_args(
        k2["N"], k2["B"], k2["iters"]))
    return 100.0 * bound / k2["launch_ms"]
