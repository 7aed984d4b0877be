"""Per-stage timing and device tracing (port of ``tpu_pathopt.profiling``;
reference: include/tools/time_recorder.h:14-25,
src/tools/time_recorder.cpp:10-33, named clock checkpoints with a per-stage
ms printout).

:class:`TimeRecorder` takes host clock checkpoints. Handed the previous
stage's outputs, it first synchronises the CUDA device they lie on, so a
stage's time is the time the device took to finish it, not the time the
host took to enqueue it. :func:`device_trace` wraps ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from tpu_pathopt_torch.torchutil import tree_leaves

logger = logging.getLogger("tpu_pathopt_torch")


class TimeRecorder:
    """Named wall-clock checkpoints (host side). Call ``record(name)`` before
    each stage and ``print_time()`` at the end, mirroring the reference
    API."""

    def __init__(self, title: str):
        self.title = title
        self._names: list[str] = []
        self._times: list[float] = []

    def record(self, name: str, block_on=None):
        """Start a named stage; first wait for the CUDA devices that hold
        any tensor of ``block_on`` (the previous stage's outputs) to finish
        their work."""
        if block_on is not None:
            for dev in {t.device for t in tree_leaves(block_on)
                        if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
        self._names.append(name)
        self._times.append(time.perf_counter())

    def stage_ms(self) -> dict:
        """Milliseconds of each recorded stage (checkpoint to the next)."""
        return {n: (b - a) * 1e3 for n, a, b in
                zip(self._names, self._times, self._times[1:])}

    def print_time(self):
        if len(self._times) < 2:
            return None
        total = (self._times[-1] - self._times[0]) * 1e3
        lines = [f"[{self.title}] total {total:.2f} ms"]
        lines += [f"  {n}: {ms:.2f} ms" for n, ms in self.stage_ms().items()]
        msg = "\n".join(lines)
        logger.info(msg)
        return msg


@contextlib.contextmanager
def device_trace(log_dir: str = "pathopt_trace"):
    """A ``torch.profiler`` trace of the CPU and, where present, the CUDA
    device, written to ``log_dir/trace.json`` as a Chrome trace (open it in
    chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def stage(recorder: TimeRecorder | None, name: str):
    if recorder is not None:
        recorder.record(name)
    yield
