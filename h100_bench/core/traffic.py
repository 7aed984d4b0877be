"""The cell's traffic as numpy arrays, drawn from the run's seed, and the
reference's inputs for one query. Imports numpy and the benchmark's own
generator only."""

from __future__ import annotations

import numpy as np

from h100_bench.gen import scenarios as gen


def batch_seeds(seed: int, n: int) -> list[int]:
    """``n`` batch seeds drawn from the run's seed."""
    rng = np.random.default_rng(seed % 2**64)
    return [int(s) for s in rng.integers(0, 2**63, size=n)]


def arrays(conf: dict, traffic: dict, batch: int, seed: int) -> dict:
    """A batch of ``batch`` queries, a quarter per lane."""
    x0, x1 = conf["route_x"]
    return gen.adversarial_arrays(batch, seed, x0, x1, traffic["offset_m"],
                                  traffic["heading_rad"])


def pool(conf: dict, traffic: dict, seed: int) -> list:
    """The ``pool`` batches a batch driver cycles through."""
    return [arrays(conf, traffic, traffic["batch"], s)
            for s in batch_seeds(seed, traffic["pool"])]


def query(a: dict, row: int) -> dict:
    """The reference's inputs for one query of batch ``a``: its route, its
    target and its start pose (x, y, heading, curvature)."""
    n = int(a["n_raw"][row])
    return dict(raw_x=np.asarray(a["raw_x"][row, :n], np.float64),
                raw_y=np.asarray(a["raw_y"][row, :n], np.float64),
                start=np.asarray((*a["start"][row], 0.0), np.float64),
                target=np.asarray(a["target"][row], np.float64))


def draw(rng, items: list, per_call: int, per_lane: int) -> list:
    """The answers a run judges: per lane, ``per_lane`` of them, the k-th
    from ``items[k % len(items)]`` (a call's result, or a batch of the
    pool), its row drawn by ``rng`` among that lane's quarter of the
    ``per_call`` rows. Returns (item, lane index, row) triples."""
    quarter = per_call // len(gen.LANES)
    out = []
    for k in range(len(gen.LANES) * per_lane):
        lane = k // per_lane
        out.append((items[k % len(items)], lane,
                    lane * quarter + int(rng.integers(quarter))))
    return out


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length
    (algorithm R) by ``rng``: the answers a run judges, kept without
    holding every call's result."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.items: list = []
        self.seen = 0

    def add(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item
