"""The traced run's readings from ``torch.profiler``: device time by
operation, the device's busy time over the profiled calls, and the mean
device time of one K2 launch."""

from __future__ import annotations

import re
import time

TOP = 10


def profile_calls(call, first: int, n: int, sync) -> dict:
    """Profile ``n`` calls (``call(i)``, each waited for by ``sync()``)
    from call index ``first``: their wall time, the device's busy time (the
    sum of every operation's device time: one stream, so none overlap), the
    operations that took most time, and K2's launches and their mean device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(first + i)
            sync()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    k2 = [r for r in rows if "fused_admm_round" in r[0]]
    k2_count = sum(r[2] for r in k2)
    return dict(window_s=wall, busy_s=sum(r[1] for r in rows),
                device_ops=[[name[:160], s] for name, s, _ in rows[:TOP]],
                k2_launches=k2_count,
                k2_launch_ms=(sum(r[1] for r in k2) / k2_count * 1e3
                              if k2_count else None))


def k2_shape(shape_launches: dict) -> int | None:
    """The knots N of K2's launches, from the program's launch keys
    (``fused_admm_round[nb=6,N=128,c=1]``); None where K2 never ran."""
    for key in shape_launches:
        m = re.match(r"fused_admm_round\[.*N=(\d+)", key)
        if m:
            return int(m.group(1))
    return None
