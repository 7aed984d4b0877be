"""Stop every process a run started, and wait until each has ended.

The reference's worker pool is joined when it closes, but the
``multiprocessing`` resource tracker it starts lives on until the
interpreter exits and ends only after it, so it would outlive the run by a
moment. ``stop_all`` ends it, and any other child still there, before the
run returns.
"""

from __future__ import annotations

import os
import signal
import time
from multiprocessing import resource_tracker


def children() -> list[int]:
    """The process ids whose parent is this process."""
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # The name, in parentheses, may hold spaces: fields follow its end.
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(entry))
    return out


def stop_tracker():
    """End the resource tracker, if this process started one, and wait."""
    resource_tracker._resource_tracker._stop()


def _reap(pids: set, deadline: float) -> set:
    """Wait for ``pids`` until ``deadline``; those still running."""
    while pids:
        for pid in list(pids):
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid
            if done:
                pids.discard(pid)
        if not pids or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    return pids


def stop_all(grace_s: float = 10.0):
    """End the resource tracker, then every other child: ``grace_s`` to
    end by itself, then SIGTERM, then SIGKILL; each waited for."""
    stop_tracker()
    left = _reap(set(children()), time.monotonic() + grace_s)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        left = _reap(left, time.monotonic() + 5.0)
