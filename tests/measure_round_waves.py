#!/usr/bin/env python3
"""Time K2 and K3 (the ADMM-round kernels) where they run in thread-block
clusters, on one GPU, to see how a launch's time follows its waves.

    python3 tests/measure_round_waves.py [--root DIR] [--out FILE]

It takes the long route's kernel inputs as ``chip_smoke.py`` records them
(``chip_smoke.capture_long``: 256 scenarios; K2 at 512, 300 and 1024
knots, K3 at (4, 3) N 384 and (3, 3) N 300) and times, with CUDA events
(``chip_smoke.cuda_time_ms``, the device's time of one call):

- ``waves``: K2 at 512 knots on its launch plan, on the first B scenarios
  for B in ``WAVE_BATCHES``;
- ``one_cta``: K2 cut to 128 and 256 knots and K3's two shapes cut to 128,
  on one CTA each (the one-block step time);
- ``clusters``: each of those launches at B 256 with every cluster size
  that has a plan (the wrappers' private ``_cluster``), each result held
  bit for bit against the launch plan's;
- ``replays``: ``pipeline.solve_batch_jit`` on the long route under each of
  ``chip_smoke.LONG_RUNS`` but the plain rounds: the first call (capture
  included), then ``REPLAYS`` replays (median ms, host clock to a
  synchronise), ok_fraction and the bytes of the key's graph pool.

Each line gives the plan (cluster size, knots and shared-memory bytes a
CTA), ``ms``, the same call with 0 iterations (``ms_no_iters``), the
dependent sweep steps of one scenario and the ns a step between the two;
a ``clusters`` line also the chain floor (those steps at the one-CTA step
time of the same block shape: one wave with every walk resident) and
``waves``, its time with iterations over that floor.
``--root`` names the tree whose ``tpu_pathopt_torch`` and ``chip_smoke.py``
are measured (default: this checkout), so that two trees can be compared
in one call, one process each. With no CUDA device it exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WAVE_BATCHES = (33, 66, 67, 99, 132, 133, 198, 199, 256)
REPLAYS = 5
# (kernel, chip_smoke.capture_long key) of the launches that take clusters
CLUSTERED = (("fused_admm_round", "long"), ("fused_admm_round", "N=300"),
             ("fused_admm_round", "N=1024"),
             ("fused_structured_round", "nb=4,r=3,N=384"),
             ("fused_structured_round", "nb=3,r=3,N=300"))


def batch_cut(args, B0: int, B: int) -> tuple:
    """The arguments of the first B of B0 scenarios (batch-last)."""
    return tuple(a[..., :B].contiguous() if hasattr(a, "shape") and a.dim()
                 and a.shape[-1] == B0 else a for a in args)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("measure_round_waves: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_pathopt_torch import kernels, pipeline, scenarios
    from tpu_pathopt_torch.config import PlannerConfig
    from tpu_pathopt_torch.solver import fused_rounds

    out = open(opts.out, "w") if opts.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.build(verbose=True)
    kernels.lib()
    ptxas = [ln.strip() for ln in kernels.build_info.get(
        "nvcc_output", "").splitlines() if "Used" in ln or "spill" in ln
        or "Compiling entry" in ln]
    emit(dict(root=opts.root, card=card, torch=torch.__version__,
              ptxas=ptxas))
    gm, scs, _ = scenarios.build_adversarial(cs.BATCH, device="cuda")
    gm_long, scs_long, _ = scenarios.build_long_route(cs.BATCH,
                                                      device="cuda")
    captured = cs.capture_long(gm_long, scs_long,
                               PlannerConfig(**scenarios.LONG_CONFIG),
                               gm, scs)
    torch.cuda.synchronize()

    one_cta_ns = {}

    def timed(kind, name, key, args, cluster=None, want=None):
        wrapper = cs.KERNELS[name][2]
        n = cs._knots(name, args)
        B = args[1 if name == "fused_admm_round" else 0].shape[-1]
        kw = {} if cluster is None else dict(_cluster=cluster)
        got = wrapper(*args, **kw)
        args0 = cs.no_iters(name, args)
        ms = cs.cuda_time_ms(lambda: wrapper(*args, **kw))
        ms0 = cs.cuda_time_ms(lambda: wrapper(*args0, **kw))
        steps = cs.chain_steps(name, args)
        shape = cs._round_shape(name, args)
        plan = fused_rounds.round_plan(name, n, *shape, cluster=cluster)
        ns = (ms - ms0) * 1e6 / steps
        line = dict(kind=kind, name=name, inputs=key, knots=n, batch=B,
                    plan=list(plan), ms=ms, ms_no_iters=ms0,
                    chain_steps=steps, ns_per_chain_step=ns,
                    bit_equal_to_plan=None if want is None
                    else cs.bit_equal(got, want))
        if kind == "one_cta":
            one_cta_ns[(name, shape)] = ns
        elif (name, shape) in one_cta_ns:
            floor = steps * one_cta_ns[(name, shape)] * 1e-6
            line.update(chain_floor_ms=floor, waves=(ms - ms0) / floor)
        emit(line)
        return got

    long = captured[("fused_admm_round", "long")]
    B0 = long[1].shape[-1]
    for B in WAVE_BATCHES:
        timed("waves", "fused_admm_round", "long", batch_cut(long, B0, B))
    for n in (256, 128):
        timed("one_cta", "fused_admm_round", f"long cut to {n}",
              cs.cut_knots("fused_admm_round", long, n))
    for name, key in CLUSTERED[3:]:
        timed("one_cta", name, f"{key} cut to 128",
              cs.cut_knots(name, captured[(name, key)], 128))
    for name, key in CLUSTERED:
        args = captured[(name, key)]
        n = cs._knots(name, args)
        nb, r = cs._round_shape(name, args)
        want = timed("clusters", name, key, args)
        for c in range(2, fused_rounds.MAX_CLUSTER + 1):
            try:
                fused_rounds.round_plan(name, n, nb, r, cluster=c)
            except ValueError:
                continue
            timed("clusters", name, key, args, cluster=c, want=want)
    for name, conf, plain, *_ in cs.LONG_RUNS:
        if plain:
            continue
        cfg = PlannerConfig(**conf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.solve_batch_jit(gm_long, scs_long, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        runs = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            res = pipeline.solve_batch_jit(gm_long, scs_long, cfg)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        emit(dict(kind="replays", run=name, first_call_s=first_s,
                  replay_ms=statistics.median(runs), replay_ms_runs=runs,
                  ok_fraction=float(res.ok.float().mean()),
                  pool_bytes=cs.pool_bytes(cs.last_segments())))
    torch.cuda.synchronize()
    emit(dict(done=True, card=card))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
