"""Closed-loop driver of ``pipeline.solve_jit``: each call one query, the
pool's ``pool`` queries (a quarter per lane, drawn from the seed) taken in
turn with the lanes interleaved."""

from __future__ import annotations

from h100_bench.core import port, traffic
from h100_bench.gen.scenarios import LANES
from tpu_pathopt_torch import pipeline
from tpu_pathopt_torch.torchutil import tree_map


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.per_call = 1
        self.arrays = traffic.arrays(ctx.conf, t, t["pool"],
                                  traffic.batch_seeds(ctx.seed, 1)[0])
        self.batch = port.scenario_batch(self.arrays, ctx.device)
        per_lane = t["pool"] // len(LANES)
        # Call i takes lane i % 4, and that lane's queries in turn.
        self.rows = [(i % len(LANES)) * per_lane + (i // len(LANES))
                     for i in range(t["pool"])]
        self.queries = [tree_map(lambda a, r=r: a[r], self.batch)
                        for r in self.rows]
        self.forget()

    def forget(self):
        """Drop the calls made so far."""
        spl = self.ctx.traffic["sample_per_lane"]
        self.kept = [traffic.Reservoir(spl, self.ctx.rng) for _ in LANES]
        self.oks = []

    def call(self, i: int):
        j = i % len(self.queries)
        res = pipeline.solve_jit(self.ctx.gm, self.queries[j], self.ctx.cfg,
                                 device=self.ctx.device)
        self.kept[j % len(LANES)].add((self.rows[j], res))
        self.oks.append(res.ok)

    def warm(self):
        self.call(0)
        self.ctx.sync()
        self.forget()

    def failed(self) -> int:
        return int(sum((~ok).int() for ok in self.oks))

    def cases(self, rng) -> list:
        """Per lane, the ``sample_per_lane`` answers drawn uniformly from
        the window's calls of that lane (none for a lane it never
        reached)."""
        return [dict(lane=LANES[row // (len(self.rows) // len(LANES))],
                     query=traffic.query(self.arrays, row),
                     answer=port.answer(res))
                for kept in self.kept for row, res in kept.items]

    def stage_input(self):
        """The first query as a batch of one."""
        r = self.rows[0]
        return tree_map(lambda a: a[r:r + 1], self.batch)
