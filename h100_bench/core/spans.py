"""CUDA events around every graph replay (a frozen copy of the port's
``chip_smoke.GraphSpans``): the device span of each replay, from the moment
the stream reaches it to its last node, the gaps between its kernels
included."""

from __future__ import annotations

import torch


class GraphSpans:
    """Records a CUDA event pair around every ``CUDAGraph.replay`` made
    inside the block, on the stream it replays on."""

    def __enter__(self):
        self.pairs = []
        self._replay = replay = torch.cuda.CUDAGraph.replay

        def timed(graph):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay(graph)
            b.record()
            self.pairs.append((a, b))
        torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay

    def spans_ms(self) -> list:
        """Each replay's device span, in ms."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]
