"""Decide ``correct``: the plain reference plans each sampled query again,
in worker processes, and the program's answers are judged against its
answers (``reference.compare``).

Runs after the window has closed; imports the reference and never the
program, so the workers load numpy and scipy only.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from h100_bench.core import procs
from h100_bench.reference import compare
from h100_bench.reference import pipeline as ref

_MAP = {}


def _init(conf: dict):
    from h100_bench.gen import scenarios as gen
    from h100_bench.reference.config import PlannerConfig
    _MAP["map"] = ref.build_map(gen.MASKS[conf["map"]](), conf["resolution"])
    _MAP["cfg"] = PlannerConfig(**conf["planner"])
    _MAP["cast"] = compare.bf16 if conf.get("control") else ref.keep
    if conf.get("control"):
        _MAP["map"] = ref.OracleMap(esdf=compare.bf16(_MAP["map"].esdf),
                                    resolution=conf["resolution"])


def _plan(q: dict) -> dict:
    out = ref.solve(_MAP["map"], q["raw_x"], q["raw_y"], q["start"],
                    q["target"], _MAP["cfg"], cast=_MAP["cast"])
    return compare.answer(out["path"], out["bounds"], out["ref"]["s"])


def plan_all(conf: dict, queries: list, workers: int | None = None,
             control: bool = False) -> list:
    """The reference's answer to each query, planned in ``workers``
    processes (spawned, one BLAS thread each). ``control``: the reference
    with every value that passes between stages rounded to bfloat16, the
    control that must come out not correct."""
    workers = workers or min(8, os.cpu_count() or 1, len(queries))
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["OPENBLAS_NUM_THREADS"] = "1"
    ctx = multiprocessing.get_context("spawn")
    try:
        with ProcessPoolExecutor(
                workers, mp_context=ctx, initializer=_init,
                initargs=(dict(conf, control=control),)) as ex:
            return list(ex.map(_plan, queries))
    finally:
        # The pool joins its workers; the tracker it started would live on.
        procs.stop_tracker()


def numbers(cfg, case: dict, want: dict) -> dict:
    """The numbers of one sampled answer against the reference's."""
    got = case["answer"]
    row = compare.numbers(got, want, cfg)
    row["start_m"] = compare.start_gap(got, case["query"]["start"])
    return row
