"""The program's own spans and node counts inside its compiled call
(``tpu_pathopt_torch.profiling.traced``), which the per-layer metrics
``call_stage_ms.*``, ``qp_loop_ms``, ``graph_nodes`` and
``entry_host_ms`` read.

Read once a traced run, by the first of those readers, after the window,
in a process of its own (this file run as a script): its own, because the
run's ``torch.profiler`` trace before the readers leaves every later
graph launch in the run's process 11–18 ms slower on the host (its CUDA
tracing stays attached). That process builds the cell's driver from the
run's ``--workload`` and ``--seed`` as ``h100_bench/run.py`` does, so it
calls the cell's own traffic: with the program's tracing on, the driver's
warm-up captures the traced key, and its calls (``drv.call(i)``, each
waited for, the pool in turn) go on unread while the card settles. A new
capture often runs at the card's slow level (more time a graph node) for
its first seconds, so the calls are read only once the median of the last
``LEVEL_CALLS`` reaches the window's fast level: its replays' 5th
percentile (``traced["spans_ms"]``) times ``LEVEL``, plus ``HOST_MS`` for
the host's part of a call. Not before ``SETTLE`` seconds; where
``SETTLE_MAX`` pass first, the key is captured again, up to ``ATTEMPTS``
captures. Then whole turns of the pool are read, for at least ``SECONDS``.
Where no capture reached the fast level, nothing is read: a number of the
slow level is not reported.

What was read is printed on one line, ``incall {...}``: the mean ms of
each of the seven stages and four QP loops on the device's clock, the
host's split of a call (``entry_ms``), the nodes each stage executes and
us a node, the set-up spans of the run, the counts of captures, warm-ups,
evictions and kernel builds over the read calls, the clock's map, the
read calls' longest gaps between the host's call and the graph on the
device, each named by the span that covers most of it (``caller`` where
none does), and the level read (``level``, ``settled_s``, ``attempts``,
``fast_ms``, the read calls' median ``wall_ms``).

Nothing (None) where the program has no tracing, where the run's compiled
call was not on a CUDA device (the CPU tests' runs), where the card stayed
at its slow level, or where the reading's process failed or loaded JAX or
the JAX package. A card run of a program with tracing that made no
compiled call, or whose command line names no cell or seed, raises."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SETTLE = 2.0
SETTLE_MAX = 20.0
ATTEMPTS = 2
LEVEL = 1.05
LEVEL_CALLS = 5
HOST_MS = 2.0
SECONDS = 4.0
TIMEOUT = 240.0
TOP = 10
ROOT = Path(__file__).resolve().parents[2]


def summary(traced: dict):
    """The reading, made on first use and kept in ``traced``."""
    if "incall" not in traced:
        traced["incall"] = _measure(_fast_ms(traced.get("spans_ms")))
    return traced["incall"]


def _fast_ms(spans):
    """The window's fast level: the 5th percentile of its replays' device
    spans (ms), or None without them."""
    if not spans:
        return None
    return sorted(spans)[len(spans) // 20]


def value(traced: dict, *path):
    """``summary(traced)[path[0]][path[1]]...``, or None."""
    got = summary(traced)
    for key in path:
        if not isinstance(got, dict) or got.get(key) is None:
            return None
        got = got[key]
    return got


def run_args(argv: list) -> tuple:
    """(cell, seed) of a run's command line (``h100_bench/run.py``'s
    ``--workload`` and ``--seed``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    args, _ = p.parse_known_args(argv)
    if args.workload is None or args.seed is None:
        raise RuntimeError(f"incall: no --workload and --seed in {argv}")
    return args.workload, args.seed


def _at_level(walls_ms: list, fast_ms) -> bool:
    """The median of the last ``LEVEL_CALLS`` calls' walls (ms) is at the
    fast level ``fast_ms`` (always, where that is unknown)."""
    last = sorted(walls_ms[-LEVEL_CALLS:])
    return fast_ms is None or last[len(last) // 2] <= LEVEL * fast_ms + HOST_MS


def _measure(fast_ms=None):
    from tpu_pathopt_torch import pipeline, profiling
    if not hasattr(pipeline, "last_compiled"):
        return None             # a program without tracing
    timed = pipeline.last_compiled()
    if timed is None:
        raise RuntimeError("incall: the run made no compiled call")
    if timed[1].type != "cuda":
        return None
    cell, seed = run_args(sys.argv[1:])
    cmd = [sys.executable, __file__, cell, str(seed), json.dumps(fast_ms)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        got = dict(error=f"no reading in {TIMEOUT} s")
    else:
        try:
            got = json.loads(res.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            got = dict(error=f"no reading (exit {res.returncode}): "
                       f"{res.stderr[-2000:]}")
    got["setup"] = [[name, label, (t1 - t0) / 1e6]
                    for name, label, t0, t1 in profiling.SETUP]
    print("incall", json.dumps(got), flush=True)
    return None if "error" in got or got["level"] != "fast" else got


def driver(cell: str, seed: int, device):
    """The cell's driver and its context on ``device``, built from the seed
    as ``h100_bench/run.py`` builds them."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from h100_bench.core import manifest, port
    files = manifest.cell_files(manifest.load(), cell)
    conf = manifest.read(files["config"])
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    ctx = SimpleNamespace(conf=conf, traffic=manifest.read(files["traffic"]),
                          seed=seed, device=device,
                          cfg=port.planner_config(conf), sync=sync,
                          rng=np.random.default_rng([seed % 2**63, 2]))
    ctx.gm = port.build_map(conf, device)
    return manifest.module(files["driver"]).Driver(ctx), ctx


def closed_loop(drv, sync, seconds: float, start: int = 0,
                multiple: int = 1) -> list:
    """``drv.call(i)`` from ``i = start``, each call waited for (``sync``),
    until ``seconds`` have passed and the calls are a whole number of
    ``multiple`` (at least one): each call's (start, end), ns on the host's
    clock."""
    walls = []
    end = time.perf_counter() + seconds
    while not walls or len(walls) % multiple or time.perf_counter() < end:
        t0 = time.perf_counter_ns()
        drv.call(start + len(walls))
        sync()
        walls.append((t0, time.perf_counter_ns()))
    return walls


def read_calls(drv, ctx, fast_ms=None, seconds: float | None = None) -> dict:
    """The driver's calls with the program's tracing on: captured by its
    warm-up, settled at the fast level ``fast_ms`` (see the module), then
    whole turns of its pool (``ctx.traffic["pool"]``) read for at least
    ``seconds`` (``SECONDS`` where None). Returns
    :func:`profiling.summarize` of the read calls with their gaps, clock
    map, counts and nodes, and the level; where no capture reached the
    fast level, only the level."""
    from tpu_pathopt_torch import pipeline, profiling
    pool = ctx.traffic["pool"]
    i = 1
    with profiling.traced() as tr:
        for attempt in range(1, ATTEMPTS + 1):
            if attempt > 1:
                pipeline.COMPILED.clear()
            drv.warm()
            walls_ms = []
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                drv.call(i)
                ctx.sync()
                i += 1
                now = time.perf_counter()
                walls_ms.append(1e3 * (now - t0))
                fast = _at_level(walls_ms, fast_ms)
                if now - start >= SETTLE_MAX or (now - start >= SETTLE
                                                 and fast):
                    break
            if fast:
                break
        level = dict(level="fast" if fast else "slow",
                     settled_s=now - start, attempts=attempt,
                     fast_ms=fast_ms,
                     settle_ms=statistics.median(walls_ms[-LEVEL_CALLS:]))
        if not fast:
            return level
        first = len(tr.calls)
        counts0 = dict(profiling.COUNTS)
        walls = closed_loop(drv, ctx.sync,
                            SECONDS if seconds is None else seconds, i, pool)
        rep = tr.report()
    drv.forget()
    calls = rep["calls"][first:]
    got = profiling.summarize(dict(rep, calls=calls))
    got.update(
        level, pool_turns=len(walls) // pool,
        wall_ms=statistics.median((b - a) / 1e6 for a, b in walls),
        gaps=profiling.longest_gaps(rep, calls, walls, TOP),
        clock=rep["clock"],
        counts={k: v - counts0[k] for k, v in profiling.COUNTS.items()},
        nodes=rep["nodes"][-1])
    return got


def main(argv: list) -> dict:
    """This file as a script: ``<cell> <seed> <fast ms as JSON>``, the
    reading of the cell's calls on the first CUDA device."""
    import torch
    cell, seed, fast_ms = argv[0], int(argv[1]), json.loads(argv[2])
    drv, ctx = driver(cell, seed, torch.device("cuda", 0))
    got = read_calls(drv, ctx, fast_ms)
    from h100_bench.run import forbidden_modules
    found = forbidden_modules()
    if found:
        return dict(error=f"loaded {', '.join(found)}")
    return got


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    print(json.dumps(main(sys.argv[1:])), flush=True)
