"""Closed-loop driver of ``pipeline.solve_batch_jit``: each call one cold
batch of the traffic's ``batch`` queries, taken in turn from a pool of
``pool`` batches drawn from the seed."""

from __future__ import annotations

from h100_bench.core import port, traffic
from h100_bench.gen.scenarios import LANES
from tpu_pathopt_torch import pipeline


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.per_call = t["batch"]
        self.arrays = traffic.pool(ctx.conf, t, ctx.seed)
        self.pool = [port.scenario_batch(a, ctx.device) for a in self.arrays]
        self.forget()

    def forget(self):
        """Drop the calls made so far."""
        n = len(LANES) * self.ctx.traffic["sample_per_lane"]
        self.kept = traffic.Reservoir(n, self.ctx.rng)
        self.oks = []

    def call(self, i: int):
        p = i % len(self.pool)
        res = pipeline.solve_batch_jit(self.ctx.gm, self.pool[p],
                                       self.ctx.cfg, device=self.ctx.device)
        self.kept.add((p, res))
        self.oks.append(res.ok)

    def warm(self):
        """Capture the one compiled key the window replays."""
        self.call(0)
        self.ctx.sync()
        self.forget()

    def failed(self) -> int:
        return int(sum((~ok).sum() for ok in self.oks))

    def cases(self, rng) -> list:
        """Per lane, ``sample_per_lane`` answers: calls drawn uniformly
        from those the window finished, in each a query of that lane."""
        return [dict(lane=LANES[lane],
                     query=traffic.query(self.arrays[p], row),
                     answer=port.answer(res, row))
                for (p, res), lane, row in traffic.draw(
                    rng, self.kept.items, self.per_call,
                    self.ctx.traffic["sample_per_lane"])]

    def stage_input(self):
        return self.pool[0]
