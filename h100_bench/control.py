"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's float32, with
every value that passes from one stage to the next (the inputs, the ESDF,
each stage's outputs, the path QP's first pass and the path) rounded to
bfloat16. Its answers are judged against the float64 reference's exactly
as a run judges the program's, on the queries a run of the cell samples,
and must come out not correct.

    python3 h100_bench/control.py --workload <cell> --seeds 11 12 13

Prints each seed's numbers beside the cell's limits, one JSON line a seed.
Imports numpy and scipy only; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def cases(conf: dict, traffic: dict, seed: int, rng) -> list:
    """The queries a run samples, drawn as the drivers draw theirs
    (``core.traffic.draw``) from the seed's pool, its batches in the order
    a window takes them (a single-query cell's pool is one batch)."""
    from h100_bench.core import traffic as tr
    from h100_bench.gen.scenarios import LANES
    if traffic["driver"] == "single":
        pool = [tr.arrays(conf, traffic, traffic["pool"],
                          tr.batch_seeds(seed, 1)[0])]
    else:
        pool = tr.pool(conf, traffic, seed)
    return [dict(lane=LANES[lane], query=tr.query(a, row))
            for a, lane, row in tr.draw(rng, pool, len(pool[0]["n_raw"]),
                                        traffic["sample_per_lane"])]


def judge_control(conf: dict, traffic: dict, limits: dict, seed: int,
                  workers=None) -> dict:
    """One seed: the control's answers to the sampled queries judged
    against the reference's."""
    import numpy as np

    from h100_bench.core import check
    from h100_bench.reference import compare
    from h100_bench.reference.config import PlannerConfig
    cfg = PlannerConfig(**conf["planner"])
    rng = np.random.default_rng([seed % 2**63, 1])
    sample = cases(conf, traffic, seed, rng)
    queries = [c["query"] for c in sample]
    got = check.plan_all(conf, queries, workers, control=True)
    want = check.plan_all(conf, queries, workers)
    rows = [check.numbers(cfg, dict(c, answer=g), w)
            for c, g, w in zip(sample, got, want)]
    correct, checks = compare.judge(rows, limits)
    return dict(seed=seed, correct=correct, checks=checks,
                worst={k: max(r[k] for r in rows) for k in rows[0]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100_bench.core import manifest
    files = manifest.cell_files(manifest.load(), args.workload)
    conf = manifest.read(files["config"])
    traffic = manifest.read(files["traffic"])
    limits = manifest.read(files["limits"])
    for seed in args.seeds:
        print(json.dumps(dict(workload=args.workload, **judge_control(
            conf, traffic, limits, seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
