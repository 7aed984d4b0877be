"""Run one cell of the benchmark of ``tpu_pathopt_torch`` on one H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's traffic and map from the seed and captures the one
compiled key the window replays; the window is a closed loop with one
caller, each call waited for; then the plain reference plans a sample of
the window's queries again and the program's answers are judged against
it. The last line of standard output is the result (one JSON object), the
last lines of standard error each number compared beside its limit. With
``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones. Exits non-zero, printing no result, when
there is no CUDA device, when the program cannot be imported, or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_pathopt"}
PROFILED_CALLS = 2
STAGE_REPS = 3


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*parts):
    print(*parts, flush=True)


def caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "h100_bench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def window(drv, seconds: float, sync):
    """The closed loop: call, wait (``sync``), record the latency, until
    ``seconds`` have passed. Returns (latencies in s, window s)."""
    lat = []
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        drv.call(i)
        sync()
        now = time.perf_counter()
        lat.append(now - t)
        i += 1
        if now - start >= seconds:
            return lat, now - start


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    caches()
    from h100_bench.core import manifest, procs
    try:
        files = manifest.cell_files(manifest.load(), args.workload)
    except KeyError:
        print(f"run: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    try:
        import tpu_pathopt_torch  # noqa: F401
    except ImportError as exc:
        print(f"run: cannot import the program: {exc}", file=sys.stderr)
        return 4
    try:
        return run(args, files, torch.device("cuda", 0))
    finally:
        procs.stop_all()


def run(args, files: dict, dev, traffic_overrides=None) -> int:
    """Everything after the look for a chip: set-up, window, judging,
    report, on ``dev`` (a CPU device runs the program's plain versions, for
    tests). ``traffic_overrides`` replace entries of the cell's traffic."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from h100_bench.core import card, check, manifest, port, spans, trace
    from h100_bench.reference import compare
    from h100_bench.reference.config import PlannerConfig as RefConfig
    from tpu_pathopt_torch import kernels

    man = manifest.load()
    on_card = dev.type == "cuda"
    conf = manifest.read(files["config"])
    traffic = dict(manifest.read(files["traffic"]),
                   **(traffic_overrides or {}))
    limits = manifest.read(files["limits"])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ctx = SimpleNamespace(conf=conf, traffic=traffic, seed=args.seed,
                          device=dev, cfg=port.planner_config(conf),
                          sync=sync,
                          rng=np.random.default_rng([args.seed % 2**63, 2]))
    ctx.gm = port.build_map(conf, dev)
    drv = manifest.module(files["driver"]).Driver(ctx)
    drv.warm()
    sync()
    setup_s = time.perf_counter() - T0
    say("setup_s", setup_s)

    say("card_start", card.state())
    segs = port.last_segments()
    segs.sync()
    rounds0 = port.rounds_total(segs)
    gs = spans.GraphSpans() if args.trace and on_card else None
    with gs or contextlib.nullcontext():
        lat, window_s = window(drv, args.seconds, sync)
    say("card_end", card.state())
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    calls = len(lat)
    q5 = float(np.quantile(lat, 0.05))
    say("calls", calls, "window_s", window_s, "latency_ms q0 q5 q25 q50 q75 "
        "q95 q100", *(round(1e3 * float(np.quantile(lat, q)), 3)
                     for q in (0, .05, .25, .5, .75, .95, 1)),
        "share_within_5pct_of_q5",
        float(np.mean(np.asarray(lat) <= 1.05 * q5)),
        # The card's speed level at the window's start and end.
        "level_ms q50_first_tenth q50_last_tenth",
        *(round(1e3 * float(np.median(part)), 3) for part in
          (lat[:max(1, calls // 10)], lat[-max(1, calls // 10):])))

    faults = []
    try:
        segs.sync()
    except ValueError as exc:
        faults.append(f"device check failed: {exc}")
    traced = {}
    if args.trace:
        traced["qp_rounds"] = (port.rounds_total(segs) - rounds0) / calls
        sp = gs.spans_ms() if gs is not None else []
        traced.update(spans_ms=sp, window_s=window_s)
        walls = [1e3 * t for t in lat]
        gaps = sorted(((w - s, i) for i, (w, s) in enumerate(zip(walls, sp))),
                      reverse=True)[:trace.TOP] if len(sp) == calls else []
    failed = drv.failed()
    cases = drv.cases(np.random.default_rng([args.seed % 2**63, 1]))
    if args.trace:
        kernels.reset_launches()
        prof = trace.profile_calls(drv.call, calls, PROFILED_CALLS, sync)
        kernels.sync_counts()
        traced["k2"] = dict(launch_ms=prof["k2_launch_ms"],
                            N=trace.k2_shape(kernels.shape_launches),
                            B=drv.per_call,
                            iters=ctx.cfg.qp_check_every)
        traced["stage_ms"] = port.profiled_stage_ms(
            ctx.gm, drv.stage_input(), ctx.cfg, STAGE_REPS, dev)
        say("profile", json.dumps({k: v for k, v in prof.items()
                                   if k != "device_ops"}))
        say("stage_ms", json.dumps(traced["stage_ms"]))
    drv.forget()
    sync()

    answers = check.plan_all(conf, [c["query"] for c in cases])
    ref_cfg = RefConfig(**conf["planner"])
    rows = [check.numbers(ref_cfg, c, w) for c, w in zip(cases, answers)]
    say("sample", json.dumps([dict(lane=c["lane"], **r)
                              for c, r in zip(cases, rows)]))
    correct, checks = compare.judge(rows, limits, {"failed": failed})
    correct = correct and not faults

    attempted = calls * drv.per_call
    metrics = {}
    if args.trace:
        for name, path in files["metrics"].items():
            value = manifest.module(path).read(traced)
            if value is not None:
                metrics[name] = {"value": value, "unit": next(
                    m["unit"] for m in man["per_layer"] if m["name"] == name)}
    else:
        e2e = dict(solves_per_s=attempted / window_s, setup_s=setup_s)
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = dict(platform="gpu" if on_card else "cpu",
                  kind=(torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
                  count=1, memory_peak_bytes=memory_peak)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=device)
    if args.trace:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = dict(
            device_ops=prof["device_ops"],
            idle_gaps=[[f"call {i}: host outside the graph (input copy, "
                        "launch, result clone, wait)", g / 1e3]
                       for g, i in gaps])
    result["checks"] = checks
    # Last of all, once every module the run needs (the metrics' readers
    # too) has been loaded: no result where JAX or the JAX package was.
    found = forbidden_modules()
    if found:
        print(f"run: loaded {', '.join(found)}; the benchmark may not load "
              "JAX or the JAX package", file=sys.stderr)
        return 5
    for msg in faults:
        print(msg, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
