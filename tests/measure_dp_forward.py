#!/usr/bin/env python3
"""Time K4 (the DP forward pass, ``csrc/dp_forward.cu``) on one GPU: its
wide lattices across the batch and every cluster size, its staged shapes,
and the fine lattice's compiled replay.

    python3 tests/measure_dp_forward.py [--root DIR] [--out FILE] [--quick]

Each K4 time is ``chip_smoke.cuda_time_ms`` (CUDA events, the device's
time of one call, median of 15 after 3 warm-ups); every launch's result is
held bit for bit to the plain version on the same inputs
(``k4_equal``; the plain version computed once a shape). Lines:

- ``staged``: K4 on the inputs the main path (31 x 35 x 35), the long route
  (``long``, 95 x 35 x 35) and the stretch configuration (``L=300``, 299 x
  35 x 35) give it, at B 256 on its own plan; and, where the tree has the
  streamed plan, the same inputs with it forced (``_cluster=1``);
- ``sweep``: K4 at 135 laterals (the fine lattice's captured inputs, its
  first B scenarios) and at 300 (a seeded random lattice made on the
  card, 31 layers) for B in ``BATCHES``, on its own plan and, where the
  tree has them, in clusters of every size the plan takes; the plain
  version's time at B 256 (135) and 32 (300); ``wide``: chip_smoke's
  ``WIDE_LATTICE`` (31 x 300 x 300, B 32, the numpy lattice of seed 7);
  ``ties 135``: ``chip_smoke.tie_lattice`` at B 64, 31 x 135 x 135 (exact
  ties, headings that take fmodf's long path);
- ``replay``: ``pipeline.solve_batch_jit`` on the adversarial batch under
  ``chip_smoke.FINE_LATTICE``: the first call (capture included), then
  ``REPLAYS`` replays (median ms, host clock to a synchronise), ok_fraction.

``--quick`` takes only 135 laterals at B 256 and 300 at B 32. ``--root``
names the tree whose ``tpu_pathopt_torch`` and ``chip_smoke.py`` are
measured (default: this checkout), so that two trees can be compared in
one call, one process each. With no CUDA device it exits with code 2.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCHES = (16, 32, 64, 132, 133, 256)
REPLAYS = 5


def k4_equal(got, want) -> bool:
    """K4's outputs equal bit for bit (chip_smoke.k4_equal; the parent tree
    may not have it)."""
    import torch
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


def device_lattice(B: int, lm1: int, K: int, seed: int = 11):
    """A random DP lattice made on the card (chip_smoke.random_lattice's
    distribution: 30% of the edges 1e30, one start lateral a scenario)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g,  # noqa: E731
                                  device="cuda")
    dir_all = (u(B, lm1, K, K) * 2 - 1) * math.pi
    base = u(B, lm1, K, K) * 3.0
    base[u(B, lm1, K, K) < 0.3] = 1e30
    h_in = (u(B, lm1) * 2 - 1) * math.pi
    cost0 = torch.full((B, K), 1e30, device="cuda")
    start = (u(B) * K).long().clamp(max=K - 1)
    cost0[torch.arange(B, device="cuda"), start] = 0.0
    dir0 = ((u(B, 1) * 2 - 1) * math.pi).expand(B, K).contiguous()
    return dir_all, base, h_in, cost0, dir0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("measure_dp_forward: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_pathopt_torch import corridor, kernels, pipeline, scenarios
    from tpu_pathopt_torch.config import PlannerConfig

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
    streamed = "_cluster" in inspect.signature(
        corridor.dp_forward).parameters
    emit(dict(root=opts.root, card=card, torch=torch.__version__,
              streamed_plan=streamed, ptxas=ptxas))

    def timed(kind, label, args, want, cluster=None, plain=False):
        B, lm1, _, K = args[0].shape
        kw = {} if cluster is None else dict(_cluster=cluster)
        got = corridor.dp_forward(*args, **kw)
        ms = cs.cuda_time_ms(lambda: corridor.dp_forward(*args, **kw))
        b_ms, _ = cs.bound_ms("dp_forward", args)
        line = dict(kind=kind, inputs=label, batch=B, layers=lm1,
                    laterals=K, forced=cluster, ms=ms, bound_ms=b_ms,
                    ns_per_layer=ms * 1e6 / lm1,
                    bit_equal=k4_equal(got, want))
        if streamed:
            line["plan"] = list(corridor.dp_card_plan(B, K, cluster=cluster))
            line["held"] = corridor._card_held(K, corridor.dp_plan(
                B, K, cluster=line["plan"][0])) if not line["plan"][5] \
                else None
        if plain:
            line["plain_ms"] = cs.cuda_time_ms(
                lambda: corridor.dp_forward_plain(*args), reps=3, warmup=1)
        emit(line)
        if not line["bit_equal"]:
            raise AssertionError(f"K4 differs from its plain version: {line}")

    def sizes(B, K):
        if not streamed:
            return []
        ok = []
        for c in range(1, corridor.DP_MAX_CLUSTER + 1):
            try:
                corridor.dp_plan(B, K, cluster=c)
                ok.append(c)
            except ValueError:
                pass
        return ok

    def sweep(label, full, batches, plain_at):
        for B in batches:
            args = tuple(a[:B].contiguous() if torch.is_tensor(a) else a
                         for a in full)
            want = corridor.dp_forward_plain(*args)
            timed("sweep", label, args, want, plain=B == plain_at)
            for c in sizes(B, args[0].shape[-1]):
                timed("sweep", label, args, want, cluster=c)
            del args, want
            torch.cuda.empty_cache()

    cfg = PlannerConfig()
    gm, scs, _ = scenarios.build_adversarial(cs.BATCH, device="cuda")
    seen: dict = {}
    fine_cfg = PlannerConfig(**cs.FINE_LATTICE)
    with cs.recording(seen, lambda name, args: "K=135" if name ==
                      "dp_forward" else None, ("dp_forward", "K=135")):
        pipeline.solve_batch(gm, scs, fine_cfg, device="cuda")
    fine = seen[("dp_forward", "K=135")]
    w1 = fine[5]
    sweep("fine lattice", fine, (256,) if opts.quick else BATCHES, 256)
    wide = tuple(torch.as_tensor(a, device="cuda")
                 for a in cs.random_lattice(*cs.WIDE_LATTICE)) + (w1,)
    want = corridor.dp_forward_plain(*wide)
    timed("wide", "WIDE_LATTICE", wide, want, plain=True)
    for c in sizes(*cs.WIDE_LATTICE[::2]):
        timed("wide", "WIDE_LATTICE", wide, want, cluster=c)
    del wide, want
    ties = tuple(torch.as_tensor(a, device="cuda")
                 for a in cs.tie_lattice(64, 31, 135)) + (w1,)
    sweep("ties 135", ties, (64,), None)
    del ties
    if not opts.quick:
        sweep("random 300", device_lattice(max(BATCHES), 31, 300) + (w1,),
              BATCHES, 32)

        # The staged shapes: each configuration's solve stops at its K4 call.
        gm_long, scs_long, _ = scenarios.build_long_route(cs.BATCH,
                                                          device="cuda")
        for label, g, sc, c in (
                ("main", gm, scs, cfg),
                ("long", gm_long, scs_long,
                 PlannerConfig(**scenarios.LONG_CONFIG)),
                ("L=300", gm_long, scs_long,
                 PlannerConfig(**scenarios.STRETCH_CONFIG))):
            with cs.recording(seen, lambda name, args, label=label: label
                              if name == "dp_forward" else None,
                              ("dp_forward", label)):
                pipeline.solve_batch(g, sc, c, device="cuda")
            args = seen[("dp_forward", label)]
            want = corridor.dp_forward_plain(*args)
            timed("staged", label, args, want)
            if streamed:
                timed("staged", label, args, want, cluster=1)
        del gm_long, scs_long

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.solve_batch_jit(gm, scs, fine_cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        runs = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            res = pipeline.solve_batch_jit(gm, scs, fine_cfg)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        emit(dict(kind="replay", run="fine_lattice", first_call_s=first_s,
                  replay_ms=statistics.median(runs), replay_ms_runs=runs,
                  ok_fraction=float(res.ok.float().mean())))
    torch.cuda.synchronize()
    emit(dict(done=True, card=card))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
