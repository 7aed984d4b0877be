"""What the drivers share: the program's inputs built from the benchmark's
own traffic, and its answers read back for judging.

Imports the program (``tpu_pathopt_torch``) and nothing else of the
repository; every name it uses is the program's public entry API.
"""

from __future__ import annotations

import torch

from h100_bench.gen import scenarios as gen
from h100_bench.reference.compare import BOUND_ROWS
from tpu_pathopt_torch import maps, pipeline
from tpu_pathopt_torch.config import PlannerConfig

PATH_FIELDS = ("x", "y", "heading", "l", "d_heading", "k", "d_k")


def planner_config(conf: dict) -> PlannerConfig:
    return PlannerConfig(**conf["planner"])


def build_map(conf: dict, device) -> maps.GridMap:
    """The configuration's map, its ESDF built by the program on ``device``
    from the occupancy mask."""
    return maps.build_map(gen.MASKS[conf["map"]](),
                          resolution=conf["resolution"],
                          pad_shape=tuple(conf["pad_shape"]), device=device)


def scenario_batch(a: dict, device) -> pipeline.Scenario:
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    s, g = a["start"], a["target"]
    return pipeline.Scenario(
        raw_x=t(a["raw_x"]), raw_y=t(a["raw_y"]), n_raw=t(a["n_raw"]).long(),
        start_x=t(s[:, 0]), start_y=t(s[:, 1]), start_heading=t(s[:, 2]),
        start_k=torch.zeros(len(s), device=device),
        target_x=t(g[:, 0]), target_y=t(g[:, 1]), target_heading=t(g[:, 2]))


def answer(res: pipeline.PathResult, row=None) -> dict:
    """One answer of a result, as numpy float64 over its valid knots;
    ``row`` None for a result without a batch axis."""
    pick = (lambda t: t) if row is None else (lambda t: t[row])
    n = int(pick(res.n_valid))
    a = {k: pick(getattr(res, k))[:n].double().cpu().numpy()
         for k in PATH_FIELDS}
    a.update({k: pick(getattr(res.bounds, k))[:n].double().cpu().numpy()
              for k in BOUND_ROWS})
    a["s"] = pick(res.s)[:n].double().cpu().numpy()
    a.update(n_valid=n, ok=bool(pick(res.ok)), blocked=bool(pick(res.blocked)))
    return a


def last_segments():
    """The runner of the compiled key used last (its device tallies)."""
    return next(reversed(pipeline.COMPILED.entries.values()))


def rounds_total(segs) -> int:
    """Rounds every QP loop of a compiled key has run, over all its calls,
    as its last ``sync()`` counted them."""
    return sum(r for r, _ in segs._synced.values())


def profiled_stage_ms(gm, scs, cfg, reps: int, device) -> dict:
    """Mean ms of each stage over ``reps`` calls of
    ``pipeline.solve_batch_profiled`` (each stage its own compiled call, a
    recorder waiting for the device between stages), after one call that
    captures the stages' graphs."""
    from tpu_pathopt_torch import profiling
    pipeline.solve_batch_profiled(gm, scs, cfg, device=device,
                                  recorder=profiling.TimeRecorder("capture"))
    sums: dict = {}
    for _ in range(reps):
        rec = profiling.TimeRecorder("stages")
        pipeline.solve_batch_profiled(gm, scs, cfg, recorder=rec,
                                      device=device)
        for name, ms in rec.stage_ms().items():
            sums[name] = sums.get(name, 0.0) + ms
    return {name: ms / reps for name, ms in sums.items()}
