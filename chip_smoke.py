#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_pathopt_torch``) on one GPU.

    python3 chip_smoke.py

It builds the four CUDA kernels from ``tpu_pathopt_torch/csrc`` (nvcc for
sm_90a, into ``tpu_pathopt_torch/_build``), then:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and the build (nvcc commands, seconds, registers and spills);
2. runs ``pipeline.solve_batch`` once on the 256-scenario adversarial batch
   while recording the first arguments each kernel wrapper is given at each
   of its shapes, and holds every kernel against its plain PyTorch version
   on those very tensors, on the card, with the stated tolerance (K4's
   parents and alive flags exactly), timing both with CUDA events;
3. drives the main path: ``solve_batch`` on the 256-scenario adversarial
   batch at the default ``PlannerConfig`` on ``cuda``, with every launch
   counter set to 0 just before and read just after; it fails unless every
   kernel launched, every scenario succeeded and every output is finite;
4. solves the golden fixture's 8 scenarios on the card and holds the result
   against the JAX package's stored result
   (``tpu_pathopt_torch/testdata/jax_adversarial_b8.npz``);
5. prints the ``kernels`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also runs the main path once under
``torch.profiler`` and prints device time by kernel, the number of kernels
launched and the device's busy share.

Every line before the last is a JSON object or the raw ``nvidia-smi`` line.
Any failed check raises, so the script exits non-zero and prints no result.
With no CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_pathopt_torch import corridor, golden, kernels, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.solver import fused_rounds

BATCH = 256
REPS = 15          # timed calls per version (median), after WARMUP calls
WARMUP = 3
REPEATS = 3        # timed main-path runs (median); the first is counted
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores

# name -> (source, TPU kernel it replaces, wrapper, plain version)
KERNELS = {
    "fused_factor": (
        "tpu_pathopt_torch/csrc/fused_factor.cu",
        "tpu_pathopt/solver/fused_rounds.py:179",
        fused_rounds.fused_factor, fused_rounds.factor_plain),
    "fused_admm_round": (
        "tpu_pathopt_torch/csrc/fused_admm_round.cu",
        "tpu_pathopt/solver/fused_rounds.py:453",
        fused_rounds.fused_admm_round, fused_rounds.admm_round_plain),
    "fused_structured_round": (
        "tpu_pathopt_torch/csrc/fused_structured_round.cu",
        "tpu_pathopt/solver/fused_rounds.py:396",
        fused_rounds.fused_structured_round,
        fused_rounds.structured_round_plain),
    "dp_forward": (
        "tpu_pathopt_torch/csrc/dp_forward.cu",
        "tpu_pathopt/corridor.py:370",
        corridor.dp_forward, corridor.dp_forward_plain),
}
# The shape the kernels line reports for each kernel: the path QP's for K1,
# TENSION2's for K3 (the others are printed on their own lines).
PRIMARY = {"fused_factor": "nb=6", "fused_structured_round": "nb=4,r=3"}
# (atol, rtol): |kernel - plain| <= atol + rtol * |plain|, elementwise. K1
# as tests/test_fused_rounds.py holds the factor kernel, K2/K3 as it holds
# the rounds (25 iterations of float32 ADMM in another summation order);
# K4's costs to 1e-5 (its parents and alive flags exactly).
TOLERANCE = {"fused_factor": (2e-4, 2e-3), "fused_admm_round": (5e-3, 5e-3),
             "fused_structured_round": (5e-3, 5e-3), "dp_forward": (1e-5, 0.0)}


def emit(obj):
    print(json.dumps(obj), flush=True)


# ------------------------------- the card ------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------- bounds of work --------------------------------

def _factor_flops(nb: int) -> int:
    """Float operations of one knot of K1 for one scenario."""
    w = nb * nb * (2 * nb - 1)
    s = nb * (nb + 1) // 2 * 2 * nb
    chol = sum(2 * j + 2 + (nb - 1 - j) * (2 * j + 1) for j in range(nb))
    inv = sum(1 + sum(2 * (r - j) + 1 for r in range(j + 1, nb))
              for j in range(nb))
    return w + s + chol + inv


def _sweep_flops(nb: int) -> int:
    """One knot of one forward or backward sweep: the W matvec, the
    subtraction and the triangular Cinv matvec."""
    return nb * (2 * nb - 1) + nb + nb * nb


def work(name: str, args) -> tuple[int, int]:
    """(bytes, float operations) the kernel's function needs on ``args``:
    each input read once, each output written once."""
    f = 4
    if name == "fused_factor":
        n, nb, _, b = args[0].shape
        return 4 * n * nb * nb * b * f, n * b * _factor_flops(nb)
    if name == "fused_admm_round":
        ci, iters = args[1], args[17]
        n, nb, _, b = ci.shape
        ins = sum(a.numel() for a in args[1:17] if torch.is_tensor(a))
        outs = 3 * n * nb * b + 2 * 2 * b + 4 * b
        # per knot and iteration: rhs 70, two sweeps, A vt 42, relax 72;
        # the residuals once: about 160 per knot
        per_iter = 70 + 2 * _sweep_flops(nb) + 42 + 72
        return (ins + outs) * f, n * b * (iters * per_iter + 160)
    if name == "fused_structured_round":
        ci, ac, iters = args[0], args[2], args[11]
        n, nb, _, b = ci.shape
        r = ac.shape[1]
        ins = sum(a.numel() for a in args[:11])
        outs = n * b * (nb + 2 * r)
        per_iter = (2 * r + 2 * nb * (2 * r - 1) + 4 * nb
                    + 2 * _sweep_flops(nb) + r * (2 * (2 * nb - 1) + 1)
                    + 9 * r + 3 * nb)
        return (ins + outs) * f, n * b * iters * per_iter
    if name == "dp_forward":
        b, lm1, kp, k = args[0].shape
        ins = sum(a.numel() for a in args[:5])
        outs = 2 * b * lm1 * k
        # per edge: sub, add pi, fmod, sign fix, sub pi, abs, div, mul,
        # add, add, compare; bytes: the alive flags are 1 byte each
        return (ins + outs) * f + b * lm1, b * lm1 * kp * k * 11
    raise KeyError(name)


def bound_ms(name: str, args) -> tuple[float, str]:
    nbytes, flops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------- capture and comparison ----------------------------

def _shape_key(name: str, args) -> str:
    if name == "fused_factor":
        return f"nb={args[0].shape[1]}"
    if name == "fused_structured_round":
        return f"nb={args[0].shape[1]},r={args[2].shape[1]}"
    return "main"


def _clone(a):
    return a.clone() if torch.is_tensor(a) else a


def capture_inputs(gm, scs, cfg, device="cuda") -> dict:
    """Run the main path once, recording the first positional arguments
    (cloned) that each wrapper gets at each of its shapes."""
    seen: dict = {}
    targets = [(fused_rounds, "fused_factor"),
               (fused_rounds, "fused_admm_round"),
               (fused_rounds, "fused_structured_round"),
               (corridor, "dp_forward")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def recorder(name, fn):
        def rec(*args, **kw):
            key = (name, _shape_key(name, args))
            if key not in seen:
                # keyword arguments (iters, alpha, sigma) go last, in order
                seen[key] = tuple(_clone(a) for a in args) + tuple(kw.values())
            return fn(*args, **kw)
        return rec

    try:
        for mod, name, fn in originals:
            setattr(mod, name, recorder(name, fn))
        pipeline.solve_batch(gm, scs, cfg, device=device)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return seen


def cuda_time_ms(fn) -> float:
    """Median over REPS calls, after WARMUP calls, of each call's time
    between two CUDA events on the current stream."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(name: str, got, want) -> dict:
    """Max abs difference over every output, the same relative to each
    output's largest finite magnitude, and whether every element is within
    the tolerance; K4's parents and alive flags must be equal."""
    atol, rtol = TOLERANCE[name]
    max_abs = max_rel = 0.0
    worst = -np.inf
    exact = True
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        if g.dtype in (torch.int32, torch.int64, torch.bool):
            exact &= bool(torch.equal(g, w))
            continue
        g, w = g.double(), w.double()
        if not bool(torch.equal(torch.isnan(g), torch.isnan(w))):
            raise AssertionError(f"{name}: NaN pattern differs")
        both_inf = (~torch.isfinite(g)) & (g == w)
        d = torch.where(both_inf | torch.isnan(g), 0.0, (g - w).abs())
        max_abs = max(max_abs, float(d.max()))
        finite = torch.isfinite(w)
        scale = float(w[finite].abs().max()) if bool(finite.any()) else 1.0
        max_rel = max(max_rel, float(d.max()) / max(scale, 1e-30))
        worst = max(worst, float((d - (atol + rtol * w.abs())).max()))
    return dict(max_abs_err=max_abs, max_rel_err=max_rel,
                tol_atol=atol, tol_rtol=rtol, within_tol=worst <= 0.0,
                exact_int_outputs=exact)


def check_kernels(captured: dict) -> tuple[dict, dict]:
    """Each kernel against its plain version on the captured tensors; one
    line per (kernel, shape). Returns (the line of each kernel's primary
    shape, each kernel's largest abs difference over all its shapes)."""
    primary, worst = {}, {}
    for (name, shape), args in sorted(captured.items()):
        _, _, wrapper, plain = KERNELS[name]
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        cmp = compare(name, got, want)
        ms = cuda_time_ms(lambda: wrapper(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args))
        b_ms, b_by = bound_ms(name, args)
        shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
        line = dict(phase="kernel", name=name, shape=shape, **cmp, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    input_shapes=shapes)
        emit(line)
        if not cmp["within_tol"] or not cmp["exact_int_outputs"]:
            raise AssertionError(f"{name} [{shape}] disagrees with its plain "
                                 f"version: {cmp}")
        if shape == PRIMARY.get(name, "main"):
            primary[name] = line
        worst[name] = max(worst.get(name, 0.0), cmp["max_abs_err"])
    torch.cuda.synchronize()
    missing = [n for n in KERNELS if n not in primary]
    if missing:
        raise AssertionError(f"the main path gave no input to {missing}")
    return primary, worst


# ------------------------------- main path -----------------------------------

def drive_main_path(gm, scs, cfg, device="cuda") -> tuple[dict, dict]:
    """One counted, timed solve_batch on the card; returns (report,
    launches)."""
    marks = []

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    stats: dict = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.solve_batch(gm, scs, cfg, device=device, stats=stats,
                               hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)

    stage_ms = {a[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}
    mask = res.mask
    for f in golden.PATH_FIELDS:
        t = getattr(res, f)
        if tuple(t.shape) != (len(res.ok), cfg.n_knots):
            raise AssertionError(f"{f}: shape {tuple(t.shape)}")
        if not bool(torch.isfinite(t[mask]).all()):
            raise AssertionError(f"{f}: non-finite values on valid knots")
    ok_fraction = float(res.ok.float().mean())
    # Two more timed runs, after the counters were read, for the spread.
    walls = [wall]
    for _ in range(REPEATS - 1):
        t0 = time.perf_counter()
        pipeline.solve_batch(gm, scs, cfg, device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    report = dict(phase="main_path", batch=len(res.ok), n_knots=cfg.n_knots,
                  seconds=wall, seconds_runs=walls,
                  solves_per_s=len(res.ok) / statistics.median(walls),
                  ok_fraction=ok_fraction, rounds=stats, stage_ms=stage_ms,
                  mean_qp_iters=float(res.qp_iters.float().mean()),
                  launches=launches)
    emit(report)
    if ok_fraction != 1.0:
        raise AssertionError(f"ok_fraction {ok_fraction} != 1.0")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"the main path launched no {idle}")
    return report, launches


def check_golden(cfg, device="cuda"):
    """The card's result on the fixture's 8 scenarios against the JAX
    package's stored result, at golden.TOLERANCES."""
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device=device)
    res = pipeline.solve_batch(gm, scs, cfg, device=device)
    failures, diffs = golden.compare(golden.arrays(res), golden.load())
    emit(dict(phase="golden", batch=golden.BATCH, diffs=diffs,
              failures=failures))
    if failures:
        raise AssertionError(f"golden fixture mismatch: {failures}")


def profile_main_path(gm, scs, cfg, wall_unprofiled: float):
    """One solve_batch under torch.profiler: device time by kernel and its
    sum, the device's busy time (one stream, so kernels do not overlap).
    The profiler's own host overhead lengthens the profiled run, so the
    busy share is given against the unprofiled wall time of the same
    solve as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.solve_batch(gm, scs, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    emit(dict(phase="profile", wall_ms=wall * 1e3,
              wall_unprofiled_ms=wall_unprofiled * 1e3,
              device_busy_ms=busy_s * 1e3,
              device_busy_share=busy_s / wall_unprofiled,
              device_busy_share_profiled=busy_s / wall,
              device_kernels=sum(r[2] for r in rows),
              top=[dict(name=k[:80], ms=t / 1e3, count=c)
                   for k, t, c in rows[:12]]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    emit(dict(phase="card", nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))

    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.lib()
    ptxas = [ln.strip() for ln in kernels.build_info.get("nvcc_output", "")
             .splitlines() if "Used" in ln or "spill" in ln
             or "Compiling entry" in ln]
    emit(dict(phase="build", commands=kernels.build_info.get("commands"),
              seconds=time.perf_counter() - t0, library=str(so),
              ptxas=ptxas))

    cfg = PlannerConfig()
    t0 = time.perf_counter()
    gm, scs, _ = scenarios.build_adversarial(BATCH, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="map", batch=BATCH, esdf_shape=list(gm.esdf.shape),
              seconds=time.perf_counter() - t0))

    captured = capture_inputs(gm, scs, cfg)
    primary, worst = check_kernels(captured)

    report, launches = drive_main_path(gm, scs, cfg)
    check_golden(cfg)
    if "--profile" in sys.argv[1:]:
        profile_main_path(gm, scs, cfg,
                          statistics.median(report["seconds_runs"]))

    rows = []
    for name, (source, replaces, _, _) in KERNELS.items():
        p = primary[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=worst[name], ms=p["ms"],
                         plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                         bound_by=p["bound_by"], library_ms=None))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
