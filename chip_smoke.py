#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_pathopt_torch``) on one GPU.

    python3 chip_smoke.py

It builds the four CUDA kernels from ``tpu_pathopt_torch/csrc`` (nvcc for
sm_90a, into ``tpu_pathopt_torch/_build``), then:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and the build (nvcc commands, seconds, registers and spills);
2. ``kernel``: runs ``pipeline.solve_batch`` on the 256-scenario
   adversarial batch at the default config, under TENSION (K1 at nb 9,
   K3 at (9, 9)) and under the rough far-away rows (K2 under the key
   ``rough``: each knot's own collision rows), and one warm replanning
   cycle (K2 under the key ``warm``, seeded with each lane's rho from the
   previous solve), while
   recording the first arguments each kernel wrapper is given at each of
   its shapes, and holds every kernel against its plain PyTorch version on
   those very tensors, on the card, with the stated tolerance (K4's parents
   and alive flags exactly), timing both with CUDA events (``ms``: the
   device's time for one call, the stream held busy while the host issues
   it; ``call_ms``: the same call as the host issues it), with
   ``ns_per_chain_step`` over each kernel's dependent steps (K3's TENSION
   round is compared and timed there but not held: see READING_ONLY); then
   K1 on a zero-pivot input (the pivot floor) at nb 6 and 9, K3 at (9, 9)
   on conditioned TENSION QPs (``conditioned_tension_round``), where it
   must also fail on inputs faulted in the d rows, and K4 on a tie-heavy
   lattice (the first-argmin rule); requires that the rough K2 round with
   the rows of one knot at every knot (the Pallas kernel's function) falls
   outside the tolerance its kernel is held to; and requires that K1, K2
   and K3 given CUDA tensors at a shape they are not built for, and a
   ``coll_coef`` of a structure K2 does not take, raise ValueError without
   a launch;
3. ``main_path``: ``solve_batch`` on the 256-scenario adversarial batch at
   the default ``PlannerConfig`` on ``cuda``, with every launch counter set
   to 0 just before and read just after; it fails unless every kernel
   launched, every scenario succeeded and every output is finite;
4. ``variants``: the same batch under TENSION + DP, TENSION2 + A*, the
   rough far-away rows and the directional prescan fallback, counted the
   same way (K1 at nb 9 and K3 at (9, 9) must launch under TENSION, K4
   must not under A*, K2 must launch under its rough key under rough),
   timed by stage over 3 runs, with the number of succeeded paths that
   are collision free (``collision.py``);
5. ``replan``: ``replan.replan_stream`` on the batch, 6 cycles warm and 6
   cold after a 1-cycle warm-up of each; every cycle must succeed and the
   warm cycles take no more ADMM iterations than the cold; and the
   ``solve_batch_profiled`` stage times of one solve;
6. ``golden``: solves the golden fixtures' 8 scenarios on the card and
   holds each result against the JAX package's stored one
   (``tpu_pathopt_torch/testdata/``: the default, TENSION, A* and rough
   configs and the 3-cycle replanning stream), and as a reading solves the
   TENSION fixture with the plain rounds on the card
   (``QPSettings(fused_rounds=False)``), a second witness of its l;
7. ``dist``: a one-rank NCCL group on 127.0.0.1: ``dist.solve_sharded``
   on the batch (counted; flags, counts and n_valid equal to
   ``solve_batch``'s, FleetStats equal to the result's counts),
   ``dist.solve_streamed`` over 4 batches of 64, and
   ``replan.replan_stream_sharded`` against ``replan.replan_stream`` over
   3 cycles;
8. ``cli``: ``cli.main(["--synthetic", "--profile", "--verbose-qp",
   "--batch", "256"])`` on the card (counted), which must print a
   succeeded solve, the stage times, a converged trace and 256/256 ok;
9. ``pscan``: one solve of 32 scenarios with the plain rounds and the
   parallel-prefix solve, ``QPSettings(fused_rounds=False, pscan=True)``,
   whose ok flags must equal the sequential solve's;
10. prints the ``kernels`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also runs the main path once under
``torch.profiler`` and prints device time by kernel, the number of kernels
launched, the device's busy share, and the launches and device time of
each of the port's kernels at each of its shapes.

Every line before the last is a JSON object or the raw ``nvidia-smi`` line.
Any failed check raises, so the script exits non-zero and prints no result.
With no CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_pathopt_torch import (cli, collision, corridor, dist, golden,
                               kernels, maps, pipeline, profiling, replan,
                               scenarios)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import structured
from tpu_pathopt_torch.smoothing.tension import build_tension_qp_blocks
from tpu_pathopt_torch.solver import fused_rounds
from tpu_pathopt_torch.torchutil import tree_map

BATCH = 256
REPS = 15          # timed calls per version (median), after WARMUP calls
WARMUP = 3
REPEATS = 3        # timed main-path runs (median); the first is counted
SLOW_PLAIN_S = 0.1           # a plain version slower than this is timed
SLOW_PLAIN_REPS = 3          # ... over this many calls, after one warm-up
REPLAN_CYCLES = 6            # timed cycles of each replanning stream
VARIANTS = {"tension": dict(smoothing_method="TENSION"),
            "astar": dict(corridor_method="ASTAR"),
            "rough": dict(rough_constraints_far_away=True),
            "prescan": dict(directional_prescan_fallback=True)}
# Launch keys each variant must show (kernels.shape_launches).
VARIANT_KEYS = {"tension": ["fused_factor[nb=9]",
                            "fused_structured_round[nb=9,r=9]"],
                "rough": ["fused_admm_round[nb=6,rough]"]}
DIST_STREAM = (4, 64)        # batches x scenarios of the streamed run
DIST_REPLAN_CYCLES = 3
PSCAN_BATCH = 32
HOLD_CYCLES = 4_000_000      # about 2 ms of device clock before a timed call
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
# Main-path inputs that are compared and timed but not held: K3's TENSION
# round. On a straight lane a lateral shift of the whole path costs the
# TENSION QP almost nothing, so d and the coordinate tied to it form a soft
# mode that float32 rounding in any other summation order moves by a few
# 1e-2 m: on the golden batch the JAX package's own Pallas kernel differs
# from the plain round by 0.023 and a CPU model of this kernel's order by
# 0.062, beyond TOLERANCE (tests/test_torch_kernels.py). K3 at (9, 9) is
# held at TOLERANCE on conditioned_tension_round instead.
READING_ONLY = {("fused_structured_round", "nb=9,r=9")}


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
        # D's lower triangle, Off_1 .. Off_{N-1} (Off_0 = 0 by contract);
        # Cinv and W written in full
        n, nb, _, b = args[0].shape
        ins = n * nb * (nb + 1) // 2 + (n - 1) * nb * nb
        return (ins + 2 * n * nb * nb) * b * f, n * b * _factor_flops(nb)
    if name == "fused_admm_round":
        # the collision rows (4 floats a knot), the factors and the rest
        ci, iters = args[1], args[17]
        n, nb, _, b = ci.shape
        ins = sum(a.numel() for a in args[:17] if torch.is_tensor(a))
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


# Where K2's and K3's argument lists hold the iteration count.
ITERS_ARG = {"fused_admm_round": 17, "fused_structured_round": 11}


def chain_steps(name: str, args) -> int:
    """Dependent steps of one launch, the chain that bounds each design:
    K1's N knots, K2/K3's sweep steps (2 sweeps x N knots x iters), K4's
    L-1 layers."""
    if name == "fused_factor":
        return args[0].shape[0]
    if name == "dp_forward":
        return args[0].shape[1]
    n = args[1 if name == "fused_admm_round" else 0].shape[0]
    return 2 * n * args[ITERS_ARG[name]]


def no_iters(name: str, args) -> tuple:
    """The same call with 0 iterations: the round's one-time cost (loading
    the scenario into shared memory, writing it back, K2's residuals)."""
    k = ITERS_ARG[name]
    return args[:k] + (0,) + args[k + 1:]


def bound_ms(name: str, args) -> tuple[float, str]:
    nbytes, flops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------- capture and comparison ----------------------------

def _shape_key(name: str, args, k2_key: str = "main") -> str:
    if name == "fused_factor":
        return f"nb={args[0].shape[1]}"
    if name == "fused_structured_round":
        return f"nb={args[0].shape[1]},r={args[2].shape[1]}"
    return k2_key if name == "fused_admm_round" else "main"


def _clone(a):
    return a.clone() if torch.is_tensor(a) else a


def capture_inputs(gm, scs, cfg, device="cuda") -> dict:
    """Run the main path once, then TENSION once, one warm replanning cycle
    and the rough rows once, recording the first positional arguments
    (cloned) that each wrapper gets at each of its shapes; K2's first call
    of the warm cycle (pass 1, seeded from the previous solve) under the
    key "warm", its first under the rough rows under "rough"."""
    seen: dict = {}
    k2_key = ["main"]
    targets = [(fused_rounds, "fused_factor"),
               (fused_rounds, "fused_admm_round"),
               (fused_rounds, "fused_structured_round"),
               (corridor, "dp_forward")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def recorder(name, fn):
        def rec(*args, **kw):
            key = (name, _shape_key(name, args, k2_key[0]))
            if key not in seen:
                # keyword arguments (iters, alpha, sigma) go last, in order
                seen[key] = tuple(_clone(a) for a in args) + tuple(kw.values())
            return fn(*args, **kw)
        return rec

    try:
        for mod, name, fn in originals:
            setattr(mod, name, recorder(name, fn))
        pipeline.solve_batch(gm, scs, cfg, device=device)
        pipeline.solve_batch(gm, scs, dataclasses.replace(
            cfg, **VARIANTS["tension"]), device=device)
        res, warm = pipeline.solve_batch_warm(gm, scs, cfg, device=device)
        k2_key[0] = "warm"
        pipeline.solve_batch_warm(gm, replan.advance_scenarios(scs, res, 1.0),
                                  cfg, warm=warm, device=device)
        k2_key[0] = "rough"
        pipeline.solve_batch(gm, scs, dataclasses.replace(
            cfg, **VARIANTS["rough"]), device=device)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return seen


def cuda_time_ms(fn, hold: bool = True, reps: int = REPS,
                 warmup: int = WARMUP) -> float:
    """Median over ``reps`` calls, after ``warmup`` calls, of each call's time
    between two CUDA events on the current stream. With ``hold`` the stream
    is first kept busy for HOLD_CYCLES (``torch.cuda._sleep``), so the
    host has enqueued the call before the device reaches the first event:
    the interval is the device's time for the call (the kernel and the
    wrapper's small copies), not the host's launch overhead, unless the host
    takes longer than the hold. Without it the interval also holds the
    host's time to issue the call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
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
    TOLERANCE; K4's parents and alive flags must be equal."""
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
        worst = max(worst, float((d - atol - rtol * w.abs()).max()))
    return dict(max_abs_err=max_abs, max_rel_err=max_rel,
                tol_atol=atol, tol_rtol=rtol, within_tol=worst <= 0.0,
                exact_int_outputs=exact)


def check_kernels(captured: dict) -> tuple[dict, dict, dict]:
    """Each kernel against its plain version on the captured tensors and on
    edge_cases; one line per (kernel, shape). Returns (the line of each
    kernel's primary shape, each kernel's largest abs difference over the
    shapes it is held at, each kernel's times and bound by shape)."""
    primary, worst, by_shape = {}, {}, {}
    for (name, shape), args in sorted(captured.items()):
        _, _, wrapper, plain = KERNELS[name]
        got = wrapper(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*args)
        torch.cuda.synchronize()
        cmp = compare(name, got, want)
        held = (name, shape) not in READING_ONLY
        ms = cuda_time_ms(lambda: wrapper(*args))
        call_ms = cuda_time_ms(lambda: wrapper(*args), hold=False)
        # The plain K1 (an FMA emulated in float64, many small launches a
        # knot) takes a large share of a second: fewer calls for it.
        slow = time.perf_counter() - t0 > SLOW_PLAIN_S
        plain_reps = SLOW_PLAIN_REPS if slow else REPS
        plain_ms = cuda_time_ms(lambda: plain(*args), reps=plain_reps,
                                warmup=1 if slow else WARMUP)
        b_ms, b_by = bound_ms(name, args)
        steps = chain_steps(name, args)
        chain = dict(chain_steps=steps, ns_per_chain_step=ms * 1e6 / steps)
        if name in ITERS_ARG:
            args0 = no_iters(name, args)
            ms0 = cuda_time_ms(lambda: wrapper(*args0))
            chain.update(ms_no_iters=ms0,
                         ns_per_chain_step=(ms - ms0) * 1e6 / steps)
        shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
        line = dict(phase="kernel", name=name, shape=shape, held=held, **cmp,
                    ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    plain_reps=plain_reps, bound_ms=b_ms, bound_by=b_by,
                    **chain, input_shapes=shapes)
        emit(line)
        if held and (not cmp["within_tol"] or not cmp["exact_int_outputs"]):
            raise AssertionError(f"{name} [{shape}] disagrees with its plain "
                                 f"version: {cmp}")
        by_shape.setdefault(name, {})[shape] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            max_abs_err=cmp["max_abs_err"], held=held)
        if (name, shape) == ("fused_admm_round", "rough"):
            check_rough_rows_seen(args, want)
        if shape == PRIMARY.get(name, "main"):
            primary[name] = line
        if held:
            worst[name] = max(worst.get(name, 0.0), cmp["max_abs_err"])
    torch.cuda.synchronize()
    missing = [n for n in KERNELS if n not in primary]
    if missing:
        raise AssertionError(f"the main path gave no input to {missing}")
    for name, shape, args in edge_cases(captured):
        _, _, wrapper, plain = KERNELS[name]
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        cmp = compare(name, got, want)
        emit(dict(phase="kernel", name=name, shape=shape, held=True, **cmp))
        if not cmp["within_tol"] or not cmp["exact_int_outputs"]:
            raise AssertionError(f"{name} [{shape}] disagrees with its plain "
                                 f"version: {cmp}")
        if name == "fused_factor" and not all(
                bool(torch.isfinite(t[..., 0]).all()) for t in got):
            raise AssertionError("fused_factor: the pivot floor did not "
                                 "keep the zero-pivot scenario finite")
        worst[name] = max(worst[name], cmp["max_abs_err"])
        if shape == "nb=9,r=9,conditioned":
            check_d_row_faults(args, want)
    return primary, worst, by_shape


def check_rough_rows_seen(args, want):
    """The check that holds K2 on the rough rows must see them: the plain
    round given the rows of scenario 0's first knot at every knot and
    scenario (the Pallas kernel's function, which reads
    coll_coef[:1, 0]) must fall outside TOLERANCE of the plain round on
    the true rows, or differ from it in where it is NaN."""
    name = "fused_admm_round"
    cc = args[0]
    const = cc[:1, :, :, :1].expand_as(cc).contiguous()
    got = fused_rounds.admm_round_plain(const, *args[1:])
    torch.cuda.synchronize()
    nan_differs = any(not bool(torch.equal(torch.isnan(g), torch.isnan(w)))
                      for g, w in zip(got, want))
    cmp = {} if nan_differs else compare(name, got, want)
    emit(dict(phase="kernel", name=name, shape="rough",
              fault="rows of knot 0 at every knot", must_fail=True,
              nan_differs=nan_differs, **cmp))
    if not nan_differs and cmp["within_tol"]:
        raise AssertionError(f"{name}: the rough check did not see the rows "
                             "of one knot put at every knot")


def conditioned_tension_round(B: int, device, seed: int = 0) -> tuple:
    """K3's arguments at (9, 9), N 22, on which float32 rounds in different
    orders agree within TOLERANCE: B TENSION QPs (the port's
    build_tension_qp_blocks) of 64 seeded points on curves, 25 m long as
    the main path's, whose d bounds come from a 32 m map with one obstacle
    across the curves and one beside them; factored by K1 at the default
    rho_bar, and started from a seeded mid-solve iterate."""
    mask = np.zeros((160, 160), bool)
    mask[40:50, 70:80] = True
    mask[75:85, 30:45] = True
    gm = maps.build_map(mask, resolution=0.2, device=device)
    rng = np.random.default_rng(seed)
    M = 64
    tt = np.linspace(0.0, 1.0, M)
    x = -12.5 + 25.0 * tt + rng.normal(scale=0.1, size=(B, M))
    y = 1.5 * np.sin(3 * tt) + rng.normal(scale=0.1, size=(B, M))
    ang = np.arctan2(np.gradient(y, axis=1), np.gradient(x, axis=1))
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    n_valid = torch.as_tensor(M - rng.integers(0, 4, B), device=device)
    cfg = PlannerConfig()
    st = cfg.qp_settings()
    qp = build_tension_qp_blocks(gm, f32(x), f32(y), f32(ang), n_valid, cfg)
    rho = st.rho_bar * structured.rho_classes(qp)
    diag, offp = structured.normal_blocks(qp, rho, st.sigma)
    lane = fused_rounds.lane
    ci, wp = fused_rounds.fused_factor(lane(diag), lane(offp))
    v = f32(rng.normal(scale=0.1, size=tuple(qp.q.shape)))
    y0 = f32(rng.normal(scale=0.05, size=tuple(qp.lb.shape)))
    return (ci, wp, lane(qp.a_cur), lane(qp.a_prev), lane(qp.q),
            lane(qp.lb), lane(qp.ub), lane(rho), lane(v),
            lane(structured.a_mul(qp, v)), lane(y0), st.check_every,
            st.alpha, st.sigma)


# The rows of a TENSION group that hold d (nb 9: [x, y, d] x 3 points).
D_ROWS = [2, 5, 8]


def d_row_faults(args):
    """K3's (9, 9) arguments changed as a kernel wrong in the d rows would
    see them: the free d bounds moved by 0.02 m, and the coupling of x and
    y to d off by 1e-3. Yields (label, args)."""
    lb, ub = args[5].clone(), args[6].clone()
    free = (ub - lb)[:, D_ROWS] > 1e-9
    lb[:, D_ROWS] += 0.02 * free
    ub[:, D_ROWS] += 0.02 * free
    yield "d_bounds+0.02", args[:5] + (lb, ub) + args[7:]
    ac = args[2].clone()
    for row in D_ROWS:
        ac[:, row - 2:row, row] *= 1.001
    yield "d_coupling*1.001", args[:2] + (ac,) + args[3:]


def check_d_row_faults(args, want):
    """The check that holds K3 at (9, 9) must see a fault of the d rows:
    the kernel on each of d_row_faults' inputs, against the plain round on
    the true ones, must fall outside TOLERANCE."""
    name = "fused_structured_round"
    for label, bad in d_row_faults(args):
        cmp = compare(name, fused_rounds.fused_structured_round(*bad), want)
        emit(dict(phase="kernel", name=name, shape="nb=9,r=9,conditioned",
                  fault=label, must_fail=True, **cmp))
        if cmp["within_tol"]:
            raise AssertionError(f"{name}: the (9, 9) check did not see the "
                                 f"fault {label}")


def zero_pivot(diag, offp, b: int = 0):
    """K1's pivot-floor case: scenario b's D_0 with row and column 0 set to
    zero, and column 0 of its first off-block too. The pivot floor gives
    Cinv_0[0][0] = 1e6 and keeps every entry finite; a plain Cholesky would
    give NaN."""
    diag, offp = diag.clone(), offp.clone()
    diag[0, 0, :, b] = 0.0
    diag[0, :, 0, b] = 0.0
    offp[1, :, 0, b] = 0.0
    return diag, offp


def tie_lattice(B: int, lm1: int, K: int, seed: int = 0):
    """A DP lattice (numpy float32: dir_all, base_all, h_in, cost0, dir0)
    where the first-argmin rule decides most parents. Scenario b groups its
    laterals in runs of g = 2 + b % 4; every direction and edge cost depends
    only on the groups of its two ends and takes a few values, so whole runs
    of kp tie exactly, within a slice of the kernel's split scan and across
    slices. Some edges are 1e30, and reference and start headings lie
    outside [-pi, pi] in part, so the wrap's fmodf path runs too."""
    rng = np.random.default_rng(seed)
    g = 2 + np.arange(B) % 4
    grp = np.arange(K)[None, :] // g[:, None]                    # (B, K)
    dir_t = rng.choice(np.float32([-2.5, -1.0, 0.0, 0.5, 1.5, 3.0]),
                       (B, lm1, K, K))
    base_t = rng.choice(np.float32([0.0, 0.5, 1.0, 1.5]), (B, lm1, K, K))
    base_t[rng.random((B, lm1, K, K)) < 0.2] = 1e30
    base_t[1 % B, lm1 // 2] = 1e30          # a scenario whose layers die
    bi = np.arange(B)[:, None, None, None]
    li = np.arange(lm1)[None, :, None, None]
    rows, cols = grp[:, None, :, None], grp[:, None, None, :]
    dir_all = dir_t[bi, li, rows, cols]
    base_all = base_t[bi, li, rows, cols]
    h_in = rng.choice(np.float32([-9.0, -1.0, 0.25, 2.0, 11.0]), (B, lm1))
    cost0 = np.where(grp == 0, 0.0, 1e30).astype(np.float32)
    dir0 = np.repeat(rng.choice(np.float32([-10.0, 0.0, 1.0, 12.0]),
                                (B, 1)), K, axis=1)
    return dir_all, base_all, h_in, cost0, dir0


def edge_cases(captured: dict):
    """Inputs the main path rarely gives, at its shapes: K1 on the
    zero-pivot input (the path QP's nb 6 and TENSION's nb 9), K3 at (9, 9)
    on conditioned_tension_round, K4 on a tie-heavy lattice. Yields (name,
    shape, args)."""
    for nb in (6, 9):
        diag, offp = captured[("fused_factor", f"nb={nb}")]
        yield "fused_factor", f"nb={nb},zero_pivot", zero_pivot(diag, offp)
    ci = captured[("fused_structured_round", "nb=9,r=9")][0]
    yield ("fused_structured_round", "nb=9,r=9,conditioned",
           conditioned_tension_round(ci.shape[-1], ci.device))
    dp_args = captured[("dp_forward", "main")]
    B, lm1, _, K = dp_args[0].shape
    yield "dp_forward", "ties", tuple(
        torch.as_tensor(a, device=dp_args[0].device)
        for a in tie_lattice(B, lm1, K)) + (dp_args[5],)


def check_no_fallback(captured: dict):
    """K1, K2 and K3 given CUDA tensors at a shape they are not built for
    (K1 at nb 5, K2's collision rows 3 wide, K3 at (9, 3)), and a
    coll_coef with a kappa coefficient in a collision row (K2 takes none),
    must raise ValueError before any launch: there is no fallback to the
    plain version."""
    diag, offp = captured[("fused_factor", "nb=6")]
    a = captured[("fused_structured_round", "nb=9,r=9")]
    k2 = captured[("fused_admm_round", "rough")]
    cut = lambda t: t[:, :3].contiguous()  # noqa: E731
    bad_coef = fused_rounds.coll_coef_from_rows(k2[0]).clone()
    bad_coef[:, :, 0, 2] = 0.5
    calls = {
        "fused_admm_round[cc (N, 2, 3, B)]": lambda: (
            fused_rounds.fused_admm_round(
                torch.cat([k2[0], k2[0][:, :, :1]], 2).contiguous(),
                *k2[1:])),
        "collision_rows[kappa in a collision row]": lambda: (
            fused_rounds.collision_rows(bad_coef)),
        "fused_factor[nb=5]": lambda: fused_rounds.fused_factor(
            diag[:, :5, :5].contiguous(), offp[:, :5, :5].contiguous()),
        "fused_structured_round[nb=9,r=3]": lambda: (
            fused_rounds.fused_structured_round(
                a[0], a[1], cut(a[2]), cut(a[3]), a[4], cut(a[5]),
                cut(a[6]), cut(a[7]), a[8], cut(a[9]), cut(a[10]),
                *a[11:])),
    }
    raised = {}
    for key, call in calls.items():
        before = dict(kernels.launches)
        try:
            call()
        except ValueError as err:
            raised[key] = str(err)
        if key not in raised or kernels.launches != before:
            raise AssertionError(f"{key}: launched or ran without raising "
                                 "ValueError")
    torch.cuda.synchronize()
    emit(dict(phase="kernel", name="no_fallback", raised=raised))


# ------------------------------- main path -----------------------------------

def check_outputs(res, cfg):
    """Every path field (B, N) and finite on the valid knots."""
    mask = res.mask
    for f in golden.PATH_FIELDS:
        t = getattr(res, f)
        if tuple(t.shape) != (len(res.ok), cfg.n_knots):
            raise AssertionError(f"{f}: shape {tuple(t.shape)}")
        if not bool(torch.isfinite(t[mask]).all()):
            raise AssertionError(f"{f}: non-finite values on valid knots")


def timed_solve(gm, scs, cfg, device="cuda"):
    """One solve_batch with CUDA events between its stages: (result, wall
    seconds, ms by stage, rounds)."""
    marks, stats = [], {}

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.solve_batch(gm, scs, cfg, device=device, stats=stats,
                               hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {a[0]: a[1].elapsed_time(b[1])
                       for a, b in zip(marks, marks[1:])}, stats


def collision_report(gm, res, cfg, device="cuda") -> dict:
    """How many succeeded paths are collision free at every valid knot
    (the reference's six-circle footprint check, collision.py), and the
    collision-free share of their valid knots."""
    car = collision.make_car_geometry(cfg, device)
    free = collision.is_state_collision_free_improved(gm, car, res.x, res.y,
                                                      res.heading)
    path_free = (free | ~res.mask).all(dim=-1) & res.ok
    ok_res = tree_map(lambda a: a[res.ok], res)
    return dict(n_ok=int(res.ok.sum()), n_ok_collision_free=int(
        path_free.sum()), knot_free_share=float(
        collision.path_collision_free(gm, car, ok_res)))


def drive_variants(gm, scs, cfg, device="cuda") -> dict:
    """solve_batch under each of VARIANTS on the batch: the first run
    counted (launch counters set to 0 just before, read just after), then
    REPEATS - 1 more; stage times and solves/s are medians over all."""
    out = {}
    for name, kw in VARIANTS.items():
        vcfg = dataclasses.replace(cfg, **kw)
        kernels.reset_launches()
        res, wall, stage_ms, stats = timed_solve(gm, scs, vcfg, device)
        launches = dict(kernels.launches)
        by_shape = dict(kernels.shape_launches)
        check_outputs(res, vcfg)
        walls, stages = [wall], [stage_ms]
        for _ in range(REPEATS - 1):
            _, w, s, _ = timed_solve(gm, scs, vcfg, device)
            walls.append(w)
            stages.append(s)
        ok_fraction = float(res.ok.float().mean())
        report = dict(
            phase="variants", variant=name, config=kw, batch=len(res.ok),
            seconds_runs=walls, solves_per_s=len(res.ok)
            / statistics.median(walls), ok_fraction=ok_fraction,
            stage_ms={k: statistics.median(s[k] for s in stages)
                      for k in stage_ms},
            rounds=stats, mean_qp_iters=float(res.qp_iters.float().mean()),
            launches=launches, shape_launches=by_shape,
            collision=collision_report(gm, res, vcfg, device))
        emit(report)
        if ok_fraction != 1.0:
            raise AssertionError(f"{name}: ok_fraction {ok_fraction} != 1.0")
        need = VARIANT_KEYS.get(name, [])
        idle = [k for k in ("fused_factor", "fused_admm_round",
                            "fused_structured_round") if not launches[k]]
        idle += [k for k in need if not by_shape.get(k)]
        if idle:
            raise AssertionError(f"{name}: launched no {idle}")
        if name == "astar" and launches["dp_forward"]:
            raise AssertionError("astar: the DP kernel K4 was launched")
        out[name] = report
    return out


def drive_replan(gm, scs, cfg, device="cuda") -> dict:
    """replan_stream on the batch, warm and cold: a 1-cycle stream of each
    to warm up, then REPLAN_CYCLES cycles of each, its kernel launches
    counted; and one solve_batch_profiled."""
    streams, launches = {}, {}
    for mode in ("warm", "cold"):
        use_warm = mode == "warm"
        replan.replan_stream(gm, scs, cfg, n_steps=1, use_warm=use_warm,
                             device=device)
        kernels.reset_launches()
        streams[mode] = dataclasses.asdict(replan.replan_stream(
            gm, scs, cfg, n_steps=REPLAN_CYCLES, advance_ds=1.0,
            use_warm=use_warm, device=device))
        launches[mode] = dict(kernels.launches)
    rec = profiling.TimeRecorder("one solve")
    pipeline.solve_batch_profiled(gm, scs, cfg, recorder=rec, device=device)
    w, c = streams["warm"], streams["cold"]
    report = dict(phase="replan", batch=len(scs.n_raw), advance_ds=1.0,
                  cycles=REPLAN_CYCLES, warm=w, cold=c,
                  iters_rest_warm_over_cold=w["mean_iters_rest"]
                  / c["mean_iters_rest"], launches=launches,
                  profiled_stage_ms=rec.stage_ms())
    emit(report)
    for mode, st in streams.items():
        if st["n_ok"] != st["n_total"]:
            raise AssertionError(f"replan {mode}: {st['n_ok']} of "
                                 f"{st['n_total']} solves ok")
    if w["mean_iters_rest"] > c["mean_iters_rest"]:
        raise AssertionError("replan: the warm cycles iterate more than the "
                             "cold ones")
    return report


def drive_main_path(gm, scs, cfg, device="cuda") -> tuple[dict, dict]:
    """One counted, timed solve_batch on the card; returns (report,
    launches)."""
    kernels.reset_launches()
    res, wall, stage_ms, stats = timed_solve(gm, scs, cfg, device)
    launches = dict(kernels.launches)
    by_shape = dict(kernels.shape_launches)
    check_outputs(res, cfg)
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
                  launches=launches, shape_launches=by_shape)
    emit(report)
    if ok_fraction != 1.0:
        raise AssertionError(f"ok_fraction {ok_fraction} != 1.0")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"the main path launched no {idle}")
    return report, launches


def check_golden(cfg, device="cuda"):
    """The card's results on the fixtures' 8 scenarios against the JAX
    package's stored results, at golden.TOLERANCES (TENSION's l at
    golden.FIXTURE_TOLERANCES; A*'s paths on the lanes of
    golden.PATH_LANES), flags exactly: solve_batch at the default, TENSION,
    A* and rough configs, and the 3-cycle warm replanning stream. Then, as
    a reading that is not held, the TENSION fixture solved with the plain
    rounds on the card (QPSettings(fused_rounds=False)): a second witness
    of how far TENSION's l lands from the fixture without the kernels'
    summation order."""
    gm, scs, _ = scenarios.build_adversarial(golden.BATCH, device=device)
    failed = {}
    for name, kw in golden.CONFIGS.items():
        fcfg = dataclasses.replace(cfg, **kw)
        want = golden.load(golden.FIXTURES[name])
        if name == "replan":
            got = golden.replan_arrays(
                lambda s, w: replan.replan_step(gm, s, w, fcfg, None,
                                                golden.REPLAN_DS,
                                                device=device),
                scs, pipeline.QPWarmStart.cold(golden.BATCH, fcfg, device))
        else:
            got = golden.arrays(pipeline.solve_batch(gm, scs, fcfg,
                                                     device=device))
        failures, diffs = golden.compare_fixture(name, got, want)
        emit(dict(phase="golden", fixture=name, batch=golden.BATCH,
                  diffs=diffs, failures=failures))
        if failures:
            failed[name] = failures
        if name == "tension":
            kernels_l = diffs["l"]
    tcfg = dataclasses.replace(cfg, **golden.CONFIGS["tension"])
    res = pipeline.solve_batch(gm, scs, tcfg, tcfg.qp_settings(
        fused_rounds=False), device=device)
    failures, diffs = golden.compare_fixture(
        "tension", golden.arrays(res), golden.load(golden.FIXTURES["tension"]))
    emit(dict(phase="golden", fixture="tension", rounds="plain",
              reading=True, l=diffs["l"], l_kernels=kernels_l, diffs=diffs,
              failures=failures))
    if failed:
        raise AssertionError(f"golden fixture mismatch: {failed}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rows(scs, sl):
    return tree_map(lambda a: a[sl], scs)


def drive_dist(gm, scs, cfg, device="cuda") -> dict:
    """The sharded fleet path in a one-rank group (NCCL on the card, gloo on
    the CPU) on 127.0.0.1: solve_sharded on the batch, counted, against
    solve_batch on the same inputs (flags, counts and n_valid equal;
    FleetStats equal to the result's counts); solve_streamed over
    DIST_STREAM; replan_stream_sharded against replan_stream."""
    n = dist.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                              process_id=0, device=device)
    try:
        mesh = dist.make_mesh(device)
        want = pipeline.solve_batch(gm, scs, cfg, device=device)
        kernels.reset_launches()
        res, st = dist.solve_sharded(gm, scs, cfg, mesh)
        launches = dict(kernels.launches)
        by_shape = dict(kernels.shape_launches)
        B = len(want.ok)
        unequal = [f for f in golden.FLAG_FIELDS + golden.COUNT_FIELDS
                   if not bool(torch.equal(getattr(res, f),
                                           getattr(want, f)))]
        stats = {f: float(getattr(st, f)) for f in (
            "n_total", "n_ok", "n_blocked", "max_qp_iters", "mean_qp_iters")}
        counted = dict(n_total=B, n_ok=int(res.ok.sum()),
                       n_blocked=int(res.blocked.sum()),
                       max_qp_iters=int(res.qp_iters.max()),
                       mean_qp_iters=float(res.qp_iters.float().mean()))
        m = res.mask
        dx = float((res.x - want.x).abs()[m].max())
        consumed = []
        n_b, per = DIST_STREAM
        total, secs, sps = dist.solve_streamed(
            gm, (_rows(scs, slice(i * per, (i + 1) * per))
                 for i in range(n_b)), cfg, mesh,
            consume=lambda r: consumed.append(int(r.ok.sum())))
        sharded = dataclasses.asdict(replan.replan_stream_sharded(
            gm, scs, cfg, mesh, n_steps=DIST_REPLAN_CYCLES))
        single = dataclasses.asdict(replan.replan_stream(
            gm, scs, cfg, n_steps=DIST_REPLAN_CYCLES, device=device))
    finally:
        torch.distributed.destroy_process_group()
    keys = ("n_steps", "n_total", "n_ok", "mean_iters", "mean_iters_first",
            "mean_iters_rest")
    report = dict(phase="dist", world_size=n, backend="nccl" if device ==
                  "cuda" else "gloo", batch=B, unequal_fields=unequal,
                  max_abs_dx=dx, fleet_stats=stats, counted=counted,
                  launches=launches, shape_launches=by_shape,
                  stream=dict(batches=n_b, per_batch=per,
                              n_total=int(total.n_total),
                              n_ok=int(total.n_ok), seconds=secs,
                              solves_per_s=sps, consumed=consumed),
                  replan_sharded={k: sharded[k] for k in keys + (
                      "solves_per_s",)},
                  replan_single={k: single[k] for k in keys + (
                      "solves_per_s",)})
    emit(report)
    if unequal:
        raise AssertionError(f"dist: solve_sharded differs from solve_batch "
                             f"in {unequal}")
    if stats != {k: float(v) for k, v in counted.items()}:
        raise AssertionError(f"dist: FleetStats {stats} != {counted}")
    idle = [k for k, c in launches.items() if not c]
    if idle:
        raise AssertionError(f"dist: launched no {idle}")
    if int(total.n_total) != n_b * per or len(consumed) != n_b:
        raise AssertionError(f"dist: stream of {int(total.n_total)} "
                             f"scenarios, consume called {len(consumed)} "
                             "times")
    if any(sharded[k] != single[k] for k in keys):
        raise AssertionError("dist: replan_stream_sharded differs from "
                             "replan_stream")
    return report


def drive_cli(extra=(), batch: int = BATCH) -> dict:
    """cli.main with --synthetic --profile --verbose-qp --batch, counted;
    its output must hold a succeeded solve, every stage's time, a converged
    trace and every scenario of the batch ok."""
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--profile", "--verbose-qp", "--batch",
                str(batch), "--out", f"{tmp}/demo_path.png", *extra]
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    text = buf.getvalue()
    lines = text.splitlines()
    need = ["solve: ok=True", f"batch {batch}: {batch}/{batch} ok",
            "[pipeline] total"] + [f"  {st}: " for st in (
                "prep", "smooth", "corridor", "post_smooth", "geometry",
                "path_qp", "finalize")]
    missing = [n for n in need if n not in text]
    converged = any(ln.endswith("converged") for ln in lines)
    emit(dict(phase="cli", argv=argv, seconds=secs, launches=launches,
              missing=missing, converged_trace=converged,
              output=lines[:60]))
    if missing or not converged or "trace truncated" in text:
        raise AssertionError(f"cli: missing {missing}, converged trace "
                             f"{converged}")
    idle = [k for k, c in launches.items() if not c]
    if idle:
        raise AssertionError(f"cli: launched no {idle}")
    return launches


def drive_pscan(gm, scs, cfg, device="cuda") -> dict:
    """A reading of the plain rounds with the parallel-prefix solve
    (QPSettings(fused_rounds=False, pscan=True)) on every 8th scenario of
    the batch, against the same with the sequential solve: ok flags
    equal."""
    sub = _rows(scs, slice(None, None, len(scs.n_raw) // PSCAN_BATCH))
    out, secs = {}, {}
    for p in (False, True):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[p] = pipeline.solve_batch(gm, sub, cfg, cfg.qp_settings(
            fused_rounds=False, pscan=p), device=device)
        out[p].ok.sum().item()
        secs[p] = time.perf_counter() - t0
    a, b = out[False], out[True]
    m = a.mask & b.mask
    report = dict(phase="pscan", batch=len(a.ok),
                  ok_sequential=int(a.ok.sum()), ok_pscan=int(b.ok.sum()),
                  flags_equal=bool(torch.equal(a.ok, b.ok)),
                  max_abs_dx=float((a.x - b.x).abs()[m].max()),
                  max_iter_diff=int((a.qp_iters - b.qp_iters).abs().max()),
                  seconds_sequential=secs[False], seconds_pscan=secs[True])
    emit(report)
    if not report["flags_equal"]:
        raise AssertionError("pscan: ok flags differ from the sequential "
                             "solve's")
    return report


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
    # The port's kernels, one row per template instantiation, so launches
    # and device time split by shape (K1 by nb, K3 by (nb, r)).
    ours = [dict(name=k[:120], ms=t / 1e3, count=c)
            for k, t, c in rows if "pathopt" in k]
    emit(dict(phase="profile", wall_ms=wall * 1e3,
              wall_unprofiled_ms=wall_unprofiled * 1e3,
              device_busy_ms=busy_s * 1e3,
              device_busy_share=busy_s / wall_unprofiled,
              device_busy_share_profiled=busy_s / wall,
              device_kernels=sum(r[2] for r in rows),
              top=[dict(name=k[:80], ms=t / 1e3, count=c)
                   for k, t, c in rows[:12]], port_kernels=ours))


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
    primary, worst, by_shape = check_kernels(captured)
    check_no_fallback(captured)

    report, launches = drive_main_path(gm, scs, cfg)
    drive_variants(gm, scs, cfg)
    drive_replan(gm, scs, cfg)
    check_golden(cfg)
    drive_dist(gm, scs, cfg)
    drive_cli()
    drive_pscan(gm, scs, cfg)
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
                         bound_by=p["bound_by"], library_ms=None,
                         by_shape=by_shape[name]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
