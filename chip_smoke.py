#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_pathopt_torch``) on one GPU.

    python3 chip_smoke.py

It builds the seven CUDA kernels and the conditional graph nodes of the
compiled calls (``graph_cond.cu``) from ``tpu_pathopt_torch/csrc`` (nvcc
for sm_90a, into ``tpu_pathopt_torch/_build``), then:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and the build (nvcc commands and version, seconds, registers
   and spills, the CUDA runtime's and driver's versions);
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
   a launch. The same for the long route's shapes (``capture_long``): K2
   at 512 knots in clusters of 2 (main and rough rows), at a ragged 300
   and at 1024, K1 at each of those runs' shapes (nb 6 at N 300, 512 and
   1024, nb 4 at N 128 and 384, nb 3 at N 96 and 300), K3 at (4, 3) N 128
   and 384 and (3, 3) N 96 and 300, K4 at 95 x 35 x 35, at 299 x 35 x 35
   and on the fine 135-lateral lattice;
   K3 at (9, 9) on 200 conditioned groups and K4 on a 300-lateral lattice
   (``wide_inputs``); K2 and K3 with a NaN bound; the cluster path forced
   at 128 and 256 knots in clusters of 2, 3, 4 and 8 bit for bit equal to
   one CTA (``check_cluster_path``); each cluster launch's time beside its
   chain floor (``chain_floors``); K4's streamed plan (``corridor.dp_plan``)
   with clusters of 1, 2, 4 and 8 forced at 135 laterals (B 256, and the
   tie-heavy lattice at B 64), at 300 (B 32) and at 137 (B 33), bit for
   bit the plain version (``check_k4_clusters``); and K2 and K3 one knot
   past their limits, K4 at 1025 laterals and in clusters of 9 refused,
   and a K4 plan the C launcher does not take raising; then K5 (the
   geometry stage, ``csrc/geometry.cu``) against the plain chain on the
   card at B 256 and B 1, bit for bit, timed beside it
   (``check_geometry``), and refused past its plan's limits; and K6 (the
   corridor's refit and lattice nodes, ``csrc/lattice.cu``) the same at B
   256 and B 1 at 35 and 135 laterals (``check_lattice``); and K7 (the
   prep stage, ``csrc/prep.cu``) the same at B 256 and B 1, and refused
   past its plan's limits (``check_prep``);
3. ``main_path``: ``solve_batch`` on the 256-scenario adversarial batch at
   the default ``PlannerConfig`` on ``cuda``, with every launch counter set
   to 0 just before and read just after; it fails unless every kernel
   launched, every scenario succeeded and every output is finite; then the
   batch in a seeded random order, whose flags and counts must equal the
   first run's once un-permuted (the paths' largest difference printed);
4. ``variants``: the same batch under TENSION + DP, TENSION2 + A*, the
   rough far-away rows and the directional prescan fallback, counted the
   same way (K1 at nb 9 and K3 at (9, 9) must launch under TENSION, K4
   must not under A*, under rough K2 must launch and the pass-1 path
   QP's collision rows must differ by knot),
   timed by stage over 3 runs, with the number of succeeded paths that
   are collision free (``collision.py``);
5. ``replan``: ``replan.replan_stream`` (each cycle the compiled
   ``replan_step``) on the batch, 6 cycles warm and 6 cold after a
   1-cycle warm-up of each; every cycle must succeed and the warm cycles
   take no more ADMM iterations than the cold; and
   ``solve_batch_profiled`` with each stage a compiled call of its own
   (``profiled_stages``): one untimed call that captures the stage keys,
   the recorded stage times (``profiled_stage_ms``, under the JAX
   package's stage names) beside the eager ones (``eager_stage_ms``) and
   their sum beside a ``solve_batch_jit`` replay, each stage key one graph
   with its conditional nodes, capture s and pool bytes, the result bit
   for bit ``solve_batch``'s with its rounds, no host read in a call;
6. ``golden``: solves the golden fixtures' 8 scenarios on the card and
   holds each result against the JAX package's stored one
   (``tpu_pathopt_torch/testdata/``: the default, TENSION at both
   deviation weights, A* and rough configs and the 3-cycle replanning
   stream, and the long route at 512 knots on its own batch), and as a
   reading solves the
   TENSION fixture with the plain rounds on the card
   (``QPSettings(fused_rounds=False)``), a second witness of its l;
6a. ``long_route``: first the geometry stage on the inputs the card once
   turned NaN at 384 segment points (``check_card_geometry``: finite and
   equal to the same stage on the CPU); then the long route
   (``scenarios.build_long_route``: 120 m routes on a 701 x 710 map at
   0.2 m, the size of the reference's demo map) solved to the end under
   each of ``LONG_RUNS``: at 512 knots, the same under the rough rows, at
   384 segment points and 300 DP layers (``scenarios.STRETCH_CONFIG``, K3
   at (4, 3) N 384 and (3, 3) N 300 in clusters) with the kernels and
   with the plain rounds, at 300 knots and at 1024 knots; and the fine DP
   lattice (135 laterals) on the adversarial batch; each counted and
   timed by stage, at ok_fraction 1.0 with every path finite on its valid
   knots and collision free, no lane but the blocked one truncated (at
   300 knots, whose 90 m horizon is shorter than the routes, every lane
   truncated at its last knot, as in the JAX package), and its launch
   keys shown (K2 at 512, 300 and 1024 knots in clusters);
6b. ``compiled``: the compiled entry points (``pipeline.solve_batch_jit``,
   the compiled ``replan.replan_step``; the whole call captured on the
   first call of a key into one CUDA graph, each QP solve's rounds a WHILE
   node and each refactor an IF node in it, replayed after) on the
   adversarial batch at the default config and under every variant, two
   input sets of one key with different round counts (the batch, its easy
   lanes repeated to the same size, the batch again), 3 replanning
   cycles, a compiled ``replan_stream`` of 6 cycles (no host read while
   its cycles are issued; timed against 6 single steps), and every
   ``LONG_RUNS`` run but the plain rounds and the fine lattice
   (``FINE_LATTICE``, K4 at 135 laterals): the first call (capture
   included) and ``REPEATS`` replays, the first of them counted; every
   field of every result equal bit for bit to the eager result of the
   same call from the phases above (``bit_unequal``), ok_fraction 1.0,
   every path finite and collision free, K1-K3 (and K4 on the DP
   corridor) launched on replay; one graph per key with a WHILE and an IF
   node for each QP solve, no host read inside a call (``HostReads``),
   the rounds and the launches by key the device counted equal to the
   eager call's; it prints the capture seconds, the replay ms (median),
   solves/s, the graph pool's bytes, the conditional nodes and the
   launches by kernel and shape on replay. It raises first unless the
   CUDA runtime and driver have conditional nodes (12.4);
6c. ``solvers``: the seven compiled standalone QP solvers (the JAX
   package's jitted ``admm.solve_qp``, ``solve_qp_batched``,
   ``trace_rounds``, ``structured.solve_structured_batched``,
   ``path_solver.solve_path_qp``, ``trace_path_rounds`` and
   ``solve_path_qp_batched``) on the oracle families' own QPs: the
   block-banded solver on TENSION2 and post (K1, K3), the batched path
   solver on pass 2 (K1, K2), the dense batched solver in float64 and
   float32, the dense scalar solver in both, the dense trace, the scalar
   path solver and its trace on 4 lanes; each held bit for bit in every
   field to its ``_eager`` twin, with one graph, its conditional nodes, no
   host read in a call, the eager rounds and launches by key; it prints
   the eager ms, the first call's s, the capture s, the replay ms and the
   pool bytes;
7. ``oracle``: each QP family of the main path (TENSION2, post, pass 2 of
   the path QP) and the TENSION QP, rebuilt through the port's own stage
   functions on the batch and solved as the pipeline solves them (K3, K2),
   then in dense form on the card in float64 to eps 1e-6 (the compiled
   ``qp/admm.solve_qp_batched``, held bit for bit to its eager twin on
   pass 2's first 8 lanes and its rho-fixed ones, each key's graph and
   pool printed):
   that optimum x* is held to the NumPy oracle (``qp/oracle.py``) on 2
   lanes of each lane class, and every lane the kernels' solver reports
   converged is held to x* (feasibility and cost gap, ``certify``); the
   float32 dense solver on the dense builder's TENSION2 QPs must agree
   with the structured one in its flags and meet the cost-gap bound; a
   pass-2 solution with one lane's l moved 0.1 m at one knot must fail;
   then the long route's pass 2 (3072 x 3074 dense) on 8 lanes, held the
   same way to its float64 optimum (``drive_long_oracle``);
8. ``dist``: a one-rank NCCL group on 127.0.0.1: ``dist.solve_sharded``
   on the batch (through the cached compiled solver; the second call
   counted; every field equal bit for bit to ``solve_batch``'s, printed as
   a ``compiled`` line with the graph checks of 6b, FleetStats equal to
   the result's counts),
   ``dist.solve_streamed`` over 4 batches of 64, and
   ``replan.replan_stream_sharded`` against ``replan.replan_stream`` over
   3 cycles;
9. ``cli``: ``cli.main(["--synthetic", "--profile", "--verbose-qp",
   "--batch", "256"])`` on the card (counted), which must print a
   succeeded solve, the stage times under the JAX package's names in its
   order, a converged trace and 256/256 ok,
   and the walkthrough ``examples/quickstart_torch.py`` on the card;
10. ``pscan``: one solve of 32 scenarios with the plain rounds and the
   parallel-prefix solve, ``QPSettings(fused_rounds=False, pscan=True)``,
   whose ok flags must equal the sequential solve's;
11. prints the ``kernels`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also runs the main path and the long
route once each under ``torch.profiler``, eager and compiled (a replay),
and prints device time by kernel, the number of kernels launched, the
device's busy share, and the launches and device time of each of the
port's kernels at each of its shapes; for the compiled calls also where
the idle time goes, timed without the profiler: outside any graph (the
call's wall time less the device span of its graph replays, CUDA events
around each, ``graph_split``) and between the kernels inside the graphs
(the spans of the calls just before and after the profiled one, where
they agree, less its busy time, where the trace holds every launch).

Every line before the last is a JSON object or the raw ``nvidia-smi`` line;
each phase's objects carry ``t_s``, the seconds since the script started.
Any failed check raises, so the script exits non-zero and prints no result.
With no CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import runpy
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pathopt_torch import (cli, collision, corridor, dist, golden,
                               kernels, maps, pipeline, profiling, replan,
                               scenarios)
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp import admm, oracle, structured
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.smoothing.post_smooth import build_post_structured
from tpu_pathopt_torch.smoothing.tension import build_tension_qp_blocks
from tpu_pathopt_torch.smoothing.tension2 import (build_tension2_qp,
                                                  build_tension2_structured)
from tpu_pathopt_torch.solver import assembly, fused_rounds, path_solver
from tpu_pathopt_torch import torchutil
from tpu_pathopt_torch.torchutil import tree_map

BATCH = 256
REPS = 15          # timed calls per version (median), after WARMUP calls
WARMUP = 3
REPEATS = 3        # timed main-path runs (median); the first is counted
SLOW_PLAIN_S = 0.1           # a plain version slower than this is timed
SLOW_PLAIN_REPS = 3          # ... over this many calls, after one warm-up
VERY_SLOW_PLAIN_S = 1.0      # ... and slower than this by one more call
REPLAN_CYCLES = 6            # timed cycles of each replanning stream
REPLAN_COMPILED_CYCLES = 3   # compiled replanning cycles held to eager
VARIANTS = {"tension": dict(smoothing_method="TENSION"),
            "astar": dict(corridor_method="ASTAR"),
            "rough": dict(rough_constraints_far_away=True),
            "prescan": dict(directional_prescan_fallback=True)}
# Launch keys each variant must show (kernels.shape_launches).
VARIANT_KEYS = {"tension": ["fused_factor[nb=9]",
                            "fused_structured_round[nb=9,r=9,N=22,c=1]"],
                "rough": ["fused_admm_round[nb=6,N=128,c=1]"]}
# The fine DP lattice (K4 at 135 laterals), on the adversarial batch. The
# long route's configurations are in LONG_RUNS.
FINE_LATTICE = dict(search_lateral_spacing=0.15, dp_laterals=135)
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


T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - T0}), flush=True)


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


class _Enough(Exception):
    """Ends a capture run once its last wanted call is recorded."""


_TARGETS = ((fused_rounds, "fused_factor"), (fused_rounds, "fused_admm_round"),
            (fused_rounds, "fused_structured_round"), (corridor, "dp_forward"))


@contextlib.contextmanager
def recording(seen: dict, key, stop=None):
    """Inside the block, each kernel wrapper records the first positional
    arguments (cloned) it gets under each (name, key(name, args)) in
    ``seen``, keyword arguments (iters, alpha, sigma, K2's key) last, in
    order; a key of None is not recorded. Once (name, key) == ``stop`` is
    recorded the run ends there (the block is left without an error)."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in _TARGETS]

    def recorder(name, fn):
        def rec(*args, **kw):
            k = key(name, args)
            if k is not None and (name, k) not in seen:
                seen[(name, k)] = tuple(_clone(a) for a in args) + tuple(
                    kw.values())
                if (name, k) == stop:
                    raise _Enough
            return fn(*args, **kw)
        return rec

    try:
        for mod, name, fn in originals:
            setattr(mod, name, recorder(name, fn))
        yield
    except _Enough:
        pass
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def capture_inputs(gm, scs, cfg, device="cuda") -> dict:
    """Run the main path once, then TENSION once, one warm replanning cycle
    and the rough rows once, recording the first positional arguments
    (cloned) that each wrapper gets at each of its shapes; K2's first call
    of the warm cycle (pass 1, seeded from the previous solve) under the
    key "warm", its first under the rough rows under "rough"."""
    seen: dict = {}
    k2_key = ["main"]
    with recording(seen, lambda name, args: _shape_key(name, args,
                                                         k2_key[0])):
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
    return seen


def _knots(name: str, args) -> int:
    """N of a K1-K3 call (K4: its layers less one)."""
    if name == "dp_forward":
        return args[0].shape[1]
    return args[1 if name == "fused_admm_round" else 0].shape[0]


def capture_long(gm, scs, cfg, gm_adv, scs_adv, device="cuda") -> dict:
    """The inputs of the long route's kernels (recorded as capture_inputs
    records them): its main path (K1 as "nb=6,N=512", "nb=4,N=128" and
    "nb=3,N=96", K2 as "long", K3 as "nb=4,r=3,N=128" and
    "nb=3,r=3,N=96", K4 as "long"); K2 under the rough rows
    ("long_rough"); K1 and K2 at a ragged 300 knots
    ("nb=6,N=300", "N=300") and at 1024 ("nb=6,N=1024", "N=1024"); K1, K3
    and K4 at scenarios.STRETCH_CONFIG (K1 as "nb=4,N=384" and
    "nb=3,N=300", K3 at (4, 3) N = 384 and (3, 3) N = 300, K4 at its 300
    layers as "L=300"); and K4 on the fine lattice of the adversarial
    batch (FINE_LATTICE, "K=135"). The runs after the first end at their
    last wanted call (drive_long_route solves each to the end)."""
    seen: dict = {}

    def with_n(name, args):
        return f"{_shape_key(name, args)},N={_knots(name, args)}"

    def main_key(name, args):
        if name in ("fused_factor", "fused_structured_round"):
            return with_n(name, args)
        return "long"

    def knots_key(tag):
        def key(name, args):
            if name == "fused_factor":
                return with_n(name, args)
            return tag if name == "fused_admm_round" else None
        return key

    def stretch_key(name, args):
        if name in ("fused_factor", "fused_structured_round"):
            return with_n(name, args)
        if name == "dp_forward":
            return f"L={_knots(name, args) + 1}"
        return None

    runs = [
        (gm, scs, cfg, main_key, None),
        (gm, scs, dataclasses.replace(cfg, **VARIANTS["rough"]),
         knots_key("long_rough"), ("fused_admm_round", "long_rough")),
        (gm, scs, dataclasses.replace(cfg, n_knots=300), knots_key("N=300"),
         ("fused_admm_round", "N=300")),
        (gm, scs, dataclasses.replace(cfg, n_knots=1024), knots_key("N=1024"),
         ("fused_admm_round", "N=1024")),
        (gm, scs, PlannerConfig(**scenarios.STRETCH_CONFIG), stretch_key,
         ("fused_structured_round",
          f"nb=3,r=3,N={scenarios.STRETCH_CONFIG['dp_layers']}")),
        (gm_adv, scs_adv, PlannerConfig(**FINE_LATTICE),
         lambda name, args: "K=135" if name == "dp_forward" else None,
         ("dp_forward", "K=135")),
    ]
    for g, sc, c, key, stop in runs:
        with recording(seen, key, stop):
            pipeline.solve_batch(g, sc, c, device=device)
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
        # knot) takes a large share of a second, the plain rounds past 300
        # knots seconds: fewer calls for them (the comparison's call above
        # warmed them up).
        plain_s = time.perf_counter() - t0
        slow, very_slow = plain_s > SLOW_PLAIN_S, plain_s > VERY_SLOW_PLAIN_S
        plain_reps = 1 if very_slow else SLOW_PLAIN_REPS if slow else REPS
        plain_ms = cuda_time_ms(lambda: plain(*args), reps=plain_reps,
                                warmup=0 if very_slow else 1 if slow
                                else WARMUP)
        b_ms, b_by = bound_ms(name, args)
        steps = chain_steps(name, args)
        chain = dict(chain_steps=steps, ns_per_chain_step=ms * 1e6 / steps)
        if name in ITERS_ARG:
            args0 = no_iters(name, args)
            ms0 = cuda_time_ms(lambda: wrapper(*args0))
            chain.update(ms_no_iters=ms0,
                         ns_per_chain_step=(ms - ms0) * 1e6 / steps)
        shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
        if name == "dp_forward":
            chain.update(plan=list(corridor.dp_card_plan(
                args[0].shape[0], args[0].shape[-1])))
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
            max_abs_err=cmp["max_abs_err"], held=held, **chain)
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
    emit(dict(phase="kernel", name="chain_floor",
              rows=chain_floors(captured, by_shape)))
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


def chain_floors(captured: dict, by_shape: dict) -> list:
    """For each K2/K3 launch that takes a cluster: its time beside its
    chain floor, the dependent steps of one scenario at the step time of
    the same kernel and block shape on one CTA (the main path's launch,
    timed above): the time of one wave if every scenario's walk were
    resident at once. ``waves`` is the launch's time over that floor."""
    one_cta = {("fused_admm_round", (6, 3)): "main"}
    for nb, r in fused_rounds.ROUND_SHAPES:
        one_cta[("fused_structured_round", (nb, r))] = f"nb={nb},r={r}"
    rows = []
    for (name, shape), args in sorted(captured.items()):
        if name not in ITERS_ARG or shape not in by_shape.get(name, {}):
            continue
        nb_r = _round_shape(name, args)
        plan = fused_rounds.round_plan(name, _knots(name, args), *nb_r)
        ref = by_shape[name].get(one_cta[(name, nb_r)])
        if plan.cluster == 1 or ref is None:
            continue
        got = by_shape[name][shape]
        floor = got["chain_steps"] * ref["ns_per_chain_step"] * 1e-6
        rows.append(dict(name=name, shape=shape, plan=list(plan),
                         ms=got["ms"], bound_ms=got["bound_ms"],
                         chain_steps=got["chain_steps"],
                         one_cta_ns_per_step=ref["ns_per_chain_step"],
                         chain_floor_ms=floor,
                         waves=(got["ms"] - got["ms_no_iters"]) / floor))
    return rows


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


def conditioned_tension_round(B: int, device, seed: int = 0,
                              groups: int = 22,
                              length: float = 25.0) -> tuple:
    """K3's arguments at (9, 9), N ``groups`` (22 as on the main path), on
    which float32 rounds in different orders agree within TOLERANCE: B
    TENSION QPs (the port's build_tension_qp_blocks) of 3 groups - 2 seeded
    points on curves at the main path's spacing (64 points over 25 m),
    whose d bounds come from a map with one obstacle across the curves and
    one beside them every 32 m (a 32 m map at 22 groups); factored by K1 at
    the default rho_bar, and started from a seeded mid-solve iterate."""
    M = 3 * groups - 2
    reps = max(1, int(np.ceil(length / 25.0)))
    mask = np.zeros((160 * reps, 160), bool)
    for t in range(reps):
        mask[40 + 160 * t:50 + 160 * t, 70:80] = True
        mask[75 + 160 * t:85 + 160 * t, 30:45] = True
    gm = maps.build_map(mask, resolution=0.2, device=device)
    rng = np.random.default_rng(seed)
    tt = np.linspace(0.0, 1.0, M)
    x = -0.5 * length + length * tt + rng.normal(scale=0.1, size=(B, M))
    y = 1.5 * np.sin(3 * tt * length / 25.0) + rng.normal(scale=0.1,
                                                          size=(B, M))
    ang = np.arctan2(np.gradient(y, axis=1), np.gradient(x, axis=1))
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    n_valid = torch.as_tensor(M - rng.integers(0, 4, B), device=device)
    cfg = PlannerConfig(n_segment_points=M)
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


def random_lattice(B: int, lm1: int, K: int, seed: int = 7):
    """A DP lattice (numpy float32: dir_all, base_all, h_in, cost0, dir0)
    of random directions and edge costs, 30% of the edges 1e30 and one
    start lateral per scenario (tests/test_torch_kernels.py's, at any
    size)."""
    rng = np.random.default_rng(seed)
    dir_all = rng.uniform(-np.pi, np.pi, (B, lm1, K, K)).astype(np.float32)
    base = rng.uniform(0.0, 3.0, (B, lm1, K, K)).astype(np.float32)
    base[rng.random((B, lm1, K, K)) < 0.3] = 1e30
    h_in = rng.uniform(-np.pi, np.pi, (B, lm1)).astype(np.float32)
    cost0 = np.full((B, K), 1e30, np.float32)
    cost0[np.arange(B), rng.integers(0, K, B)] = 0.0
    dir0 = np.broadcast_to(rng.uniform(-np.pi, np.pi, (B, 1)),
                           (B, K)).astype(np.float32)
    return dir_all, base, h_in, cost0, dir0


# Beyond the path's shapes, held and timed beside them: K3 at (9, 9) on 200
# conditioned groups (a 50 m curve), K4 on a random lattice of 300 laterals.
WIDE_GROUPS, WIDE_LENGTH = 200, 50.0
WIDE_LATTICE = (32, 31, 300)       # B, layers - 1, laterals


def wide_inputs(captured: dict) -> dict:
    """K3 at (9, 9), N WIDE_GROUPS, on conditioned_tension_round, and K4 on
    random_lattice at WIDE_LATTICE, keyed as capture_inputs keys, on the
    captured inputs' device and batch."""
    ci = captured[("fused_structured_round", "nb=9,r=9")][0]
    w1 = captured[("dp_forward", "main")][5]
    lat = tuple(torch.as_tensor(a, device=ci.device)
                for a in random_lattice(*WIDE_LATTICE))
    return {("fused_structured_round",
             f"nb=9,r=9,N={WIDE_GROUPS},conditioned"):
            conditioned_tension_round(ci.shape[-1], ci.device,
                                      groups=WIDE_GROUPS,
                                      length=WIDE_LENGTH),
            ("dp_forward", f"K={WIDE_LATTICE[2]}"): lat + (w1,)}


def nan_bound(args, i: int) -> tuple:
    """K2/K3 arguments with the lower bound (argument i) of scenario 0's
    first row at knot 5 set to NaN."""
    lb = args[i].clone()
    lb[5, 0, 0] = float("nan")
    return args[:i] + (lb,) + args[i + 1:]


def edge_cases(captured: dict):
    """Inputs the main path rarely gives, at its shapes: K1 on the
    zero-pivot input (the path QP's nb 6 and TENSION's nb 9), K3 at (9, 9)
    on conditioned_tension_round, K2 and K3 with a NaN lower bound (the
    projection must make its lane NaN, as jnp.clip does), K4 on a
    tie-heavy lattice (also at the fine lattice's 135 laterals, a quarter
    of its batch). Yields (name, shape, args)."""
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
    for name, key, arg in (("fused_admm_round", "main", 4),
                           ("fused_structured_round", "nb=4,r=3", 5)):
        yield name, f"{key},nan_bound", nan_bound(captured[(name, key)], arg)
    fine = captured.get(("dp_forward", "K=135"))
    if fine is not None:
        B, lm1, _, K = fine[0].shape
        yield "dp_forward", f"K={K},ties", tuple(
            torch.as_tensor(a, device=fine[0].device)
            for a in tie_lattice(B // 4, lm1, K)) + (fine[5],)


# The cluster path forced at shapes one CTA also runs: (kernel, captured
# inputs, knots they are cut to, forced cluster sizes). Each must equal the
# one-CTA launch bit for bit.
CLUSTER_CHECKS = (
    ("fused_admm_round", "main", 128, (2, 3)),
    ("fused_admm_round", "long", 256, (2, 3)),
    ("fused_structured_round", "nb=4,r=3,N=128", 128, (2, 3)),
    ("fused_structured_round", "nb=4,r=3,N=384", 256, (2, 3)),
    ("fused_structured_round", "nb=3,r=3,N=300", 128, (2, 3)),
    ("fused_structured_round", "nb=3,r=3,N=300", 256, (2, 3)),
    ("fused_structured_round", f"nb=9,r=9,N={WIDE_GROUPS},conditioned", 128,
     (2, 3)),
)
# The same at the cluster sizes the configurations' plans reach (c 4 at
# 1024 knots) and the largest: each cluster CTA streams G and H through
# its ring of bulk copies (csrc/btri_sweep.cuh).
CLUSTER_CHECKS_WIDE = tuple((name, key, n, (4, 8))
                            for name, key, n, _ in CLUSTER_CHECKS)


def cut_knots(name: str, args, n: int) -> tuple:
    """K2/K3 arguments cut to their first n knots: the leading rows of a
    block-tridiagonal factor are the factor of the leading rows, so the cut
    round is a round of the cut QP (K2's end row clamps to the last knot)."""
    N = _knots(name, args)
    return tuple(a[:n].contiguous() if torch.is_tensor(a) and a.dim() >= 2
                 and a.shape[0] == N else a for a in args)


def bit_equal(got, want) -> bool:
    """Every output equal bit for bit (NaN where the other is NaN)."""
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        nan = torch.isnan(g)
        if not torch.equal(nan, torch.isnan(w)):
            return False
        if not torch.equal(torch.where(nan, 0, g.view(torch.int32)),
                           torch.where(nan, 0, w.view(torch.int32))):
            return False
    return True


def check_cluster_path(captured: dict):
    """K2 and K3 with the cluster path forced (the wrappers' private
    ``_cluster``) at 128 and 256 knots, where one CTA also runs them, at
    the sizes of CLUSTER_CHECKS and CLUSTER_CHECKS_WIDE: the result must
    equal the one-CTA launch's bit for bit, and each launch be counted
    under its own plan."""
    out = []
    for name, key, n, sizes in CLUSTER_CHECKS + CLUSTER_CHECKS_WIDE:
        wrapper = KERNELS[name][2]
        args = cut_knots(name, captured[(name, key)], n)
        one = wrapper(*args)
        for c in sizes:
            kernels.reset_launches()
            got = wrapper(*args, _cluster=c)
            torch.cuda.synchronize()
            keys = [k for k in kernels.shape_launches
                    if k.endswith(f",N={n},c={c}]")]
            row = dict(name=name, inputs=key, knots=n, cluster=c,
                       plan=tuple(fused_rounds.round_plan(
                           name, n, *_round_shape(name, args), cluster=c)),
                       launch_keys=keys, bit_equal=bit_equal(got, one))
            out.append(row)
            if not row["bit_equal"] or not keys:
                raise AssertionError(f"cluster path: {row}")
    emit(dict(phase="kernel", name="cluster_path", checks=out))


# K4 with the streamed plan's cluster size forced (the wrapper's private
# ``_cluster``): (label, inputs, sizes). "captured": the inputs
# capture_long and wide_inputs record under the label; a tuple: (maker,
# B, layers - 1, laterals) of a lattice made here, at a ragged B. Each
# launch must equal the plain version bit for bit, and so each other.
K4_CLUSTER_SIZES = (1, 2, 4, 8)
K4_CLUSTER_CHECKS = (
    ("K=135", "captured", K4_CLUSTER_SIZES),
    (f"K={WIDE_LATTICE[2]}", "captured", K4_CLUSTER_SIZES),
    ("K=137,B=33", ("random", 33, 31, 137), K4_CLUSTER_SIZES),
    ("K=135,ties", ("ties", 64, 31, 135), K4_CLUSTER_SIZES),
)


def k4_equal(got, want) -> bool:
    """K4's outputs equal bit for bit: costs as int32 bits, parents and
    alive flags exactly."""
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


def check_k4_clusters(captured: dict):
    """K4 at each of K4_CLUSTER_CHECKS with its own plan and with each
    forced cluster size: every result equal bit for bit to the plain
    version, each launch counted under its plan's key."""
    w1 = captured[("dp_forward", "main")][5]
    out = []
    for label, source, sizes in K4_CLUSTER_CHECKS:
        if source == "captured":
            args = captured[("dp_forward", label)]
        else:
            make = random_lattice if source[0] == "random" else tie_lattice
            args = tuple(torch.as_tensor(a, device="cuda")
                         for a in make(*source[1:])) + (w1,)
        B, _, _, K = args[0].shape
        want = corridor.dp_forward_plain(*args)
        for c in (None,) + tuple(sizes):
            kernels.reset_launches()
            got = corridor.dp_forward(*args, _cluster=c)
            torch.cuda.synchronize()
            plan = corridor.dp_card_plan(B, K, cluster=c)
            key = f"dp_forward[K={K},c={plan.cluster}]"
            row = dict(inputs=label, batch=B, laterals=K, forced=c,
                       plan=list(plan), launch_keys=dict(
                           kernels.shape_launches),
                       bit_equal=k4_equal(got, want))
            out.append(row)
            if not row["bit_equal"] or kernels.shape_launches != {key: 1}:
                raise AssertionError(f"K4 cluster path: {row}")
    emit(dict(phase="kernel", name="dp_forward_clusters", checks=out))


def _round_shape(name: str, args) -> tuple:
    """(nb, r) of K2/K3 arguments."""
    if name == "fused_admm_round":
        return 6, 3
    return args[0].shape[1], args[2].shape[1]


def past_limit(name: str, args):
    """K2/K3 arguments (batch cut to 1) grown to one knot past the kernel's
    limit at their block shape, zero-filled."""
    nb, r = _round_shape(name, args)
    n = fused_rounds.round_limit(name, nb, r) + 1
    N = _knots(name, args)
    out = []
    for a in args:
        if torch.is_tensor(a):
            a = a[..., :1]
            if a.dim() >= 2 and a.shape[0] == N:
                a = a.new_zeros((n,) + tuple(a.shape[1:]))
            a = a.contiguous()
        out.append(a)
    return n, tuple(out)


def check_no_fallback(captured: dict):
    """K1, K2 and K3 given CUDA tensors at a shape they are not built for
    (K1 at nb 5, K2's collision rows 3 wide, K3 at (9, 3)), a coll_coef
    with a kappa coefficient in a collision row (K2 takes none), K2 and K3
    one knot past their limits (fused_rounds.round_limit) and K4 at 1025
    laterals must raise ValueError before any launch: there is no fallback
    to the plain version."""
    diag, offp = captured[("fused_factor", "nb=6")]
    a = captured[("fused_structured_round", "nb=9,r=9")]
    k2 = captured[("fused_admm_round", "rough")]
    cut = lambda t: t[:, :3].contiguous()  # noqa: E731
    bad_coef = fused_rounds.coll_coef_from_rows(k2[0]).clone()
    bad_coef[:, :, 0, 2] = 0.5
    K = corridor.DP_MAX_LATERALS + 1
    wide = [torch.zeros(shape, device=diag.device) for shape in (
        (1, 1, K, K), (1, 1, K, K), (1, 1), (1, K), (1, K))]
    past = {}
    for name, key in (("fused_admm_round", "main"),
                      ("fused_structured_round", "nb=4,r=3"),
                      ("fused_structured_round", "nb=3,r=3"),
                      ("fused_structured_round", "nb=9,r=9")):
        n, args = past_limit(name, captured[(name, key)])
        past[f"{name}[{key},N={n}]"] = (KERNELS[name][2], args)
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
        f"dp_forward[K={K}]": lambda: corridor.dp_forward(*wide, 16.0),
        **{k: (lambda fn=fn, args=args: fn(*args))
           for k, (fn, args) in past.items()},
    }
    fine = captured[("dp_forward", "K=135")]
    calls["dp_forward[K=135,c=9]"] = lambda: corridor.dp_forward(
        *fine, _cluster=9)
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
    # The C launcher refuses a plan that is not dp_plan's (here a ring one
    # chunk deeper than its bytes), and the wrapper raises: no launch, no
    # count.
    plan = corridor.dp_card_plan
    before = dict(kernels.launches)
    try:
        corridor.dp_card_plan = lambda *a, **kw: plan(*a, **kw)._replace(
            depth=plan(*a, **kw).depth + 1)
        corridor.dp_forward(*fine)
    except RuntimeError as err:
        raised["dp_forward[plan refused by the launcher]"] = str(err)
    finally:
        corridor.dp_card_plan = plan
    if "dp_forward[plan refused by the launcher]" not in raised or \
            kernels.launches != before:
        raise AssertionError("dp_forward: a plan the launcher refuses ran")
    torch.cuda.synchronize()
    emit(dict(phase="kernel", name="no_fallback", raised=raised))


# ------------------------------ K5, geometry ---------------------------------

# K5 replaces no Pallas kernel: the geometry stage's chain
# (tpu_pathopt/refpath.py's lax.scan at :97 and tpu_pathopt/bounds.py's
# update_bounds). It is checked and timed at the main path's shapes, B 256
# and B 1 (M 32, N 128), beside the plain chain on the card.
GEOMETRY_BATCHES = (256, 1)
GEOMETRY_SOURCE = "tpu_pathopt_torch/csrc/geometry.cu"
GEOMETRY_REPLACES = ("tpu_pathopt/refpath.py:97 (lax.scan), "
                     "tpu_pathopt/bounds.py (update_bounds)")


def geometry_stage_inputs(gm, scs, cfg) -> tuple:
    """(gm, scs, xs2, ys2, cor, l_post): the geometry stage's inputs as the
    stages before it make them."""
    settings = cfg.qp_settings()
    prep = pipeline.stage_prep(scs, cfg)
    smooth = pipeline.stage_smooth(gm, prep, cfg, settings)
    xs2, ys2, cor = pipeline.stage_corridor(gm, scs, smooth, cfg)
    l_post, _ = pipeline.stage_post_smooth(cor, cfg, settings)
    return gm, scs, xs2, ys2, cor, l_post


def geometry_work(args, cfg) -> tuple[int, int]:
    """(bytes, float operations) of K5 on ``args``: each input read once
    (the ESDF's stencil table whole), each output written once; the
    operations of the Newton steps (about 40 a step), the probes (about 25
    each: 2 sides x 26 and the state's own, a (axle, knot)) and the
    resample (about 60 a step)."""
    gm, scs, xs2, ys2, cor, l_post = args
    B, M = l_post.shape
    S, N = xs2.s.shape[-1], cfg.n_knots
    ins = B * (9 * S + 3 * M + 5) * 4 + B * 2 * 8 + gm.quad.numel() * 4
    outs = B * (15 * N + 2) * 4 + B * (8 + 3)
    per_axle = 2 * cfg.newton_iters * 40 + (2 * 26 + 1) * 25
    flops = B * (N * 60 + 2 * N * per_axle + 256 * 40)
    return ins + outs, flops


def geometry_chain_steps(args, cfg) -> int:
    """K5's dependent steps: the refit's two Thomas passes over the M
    layers, the trim's Newton steps, the resample's N steps and an axle's
    Newton steps."""
    M = args[-1].shape[1]
    return 2 * M + cfg.newton_iters + cfg.n_knots + cfg.newton_iters


def check_geometry(gm, scs, cfg) -> dict:
    """K5 against the plain chain on the card at GEOMETRY_BATCHES, every
    output bit for bit; each timed (``ms``: device time, the stream held
    busy; ``call_ms``: as the host issues it) beside its bound, its chain
    and the plain chain's time. Returns the lines by shape."""
    rows = {}
    for b in GEOMETRY_BATCHES:
        args = geometry_stage_inputs(gm, tree_map(lambda a, b=b: a[:b], scs),
                                     cfg)
        got = pipeline.geometry_kernel(*args, cfg)
        want = pipeline._geometry_plain(*args, cfg)
        torch.cuda.synchronize()
        unequal = bit_unequal(got, want)
        ms = cuda_time_ms(lambda: pipeline.geometry_kernel(*args, cfg))
        call_ms = cuda_time_ms(lambda: pipeline.geometry_kernel(*args, cfg),
                               hold=False)
        plain_ms = cuda_time_ms(lambda: pipeline._geometry_plain(*args, cfg),
                                reps=SLOW_PLAIN_REPS, warmup=1)
        nbytes, flops = geometry_work(args, cfg)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        steps = geometry_chain_steps(args, cfg)
        line = dict(phase="kernel", name="geometry", shape=f"B={b}",
                    held=True, bit_equal=not unequal, unequal=unequal,
                    ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    plain_reps=SLOW_PLAIN_REPS, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    chain_steps=steps, ns_per_chain_step=ms * 1e6 / steps,
                    plan=list(pipeline.geometry_plan(
                        args[2].s.shape[-1], args[-1].shape[1],
                        cfg.n_knots)))
        emit(line)
        if unequal:
            raise AssertionError(f"geometry [B={b}] differs from the plain "
                                 f"chain: {unequal}")
        rows[f"B={b}"] = line
    # Past the plan's limits a CUDA input raises before any launch.
    before = dict(kernels.launches)
    try:
        pipeline.geometry_kernel(*args, dataclasses.replace(
            cfg, n_knots=pipeline.GEO_MAX_KNOTS + 1))
    except ValueError as err:
        emit(dict(phase="kernel", name="geometry", shape="past_limit",
                  raised=str(err)))
    else:
        raise AssertionError("geometry: a plan past its limits launched")
    if kernels.launches != before:
        raise AssertionError("geometry: a refused plan counted a launch")
    return rows


# ------------------------------ K6, lattice ----------------------------------

# K6 replaces no Pallas kernel: the DP corridor's refit and lattice nodes
# (tpu_pathopt/pipeline.py's _refit_splines, tpu_pathopt/corridor.py's
# _build_lattice_geom, feasibility and _rough_bounds, XLA code). It is
# checked and timed at the cells' shapes, B 256 and B 1 at 35 and 135
# laterals, beside the plain chain on the card.
LATTICE_SHAPES = ((256, {}), (1, {}), (256, FINE_LATTICE), (1, FINE_LATTICE))
LATTICE_SOURCE = "tpu_pathopt_torch/csrc/lattice.cu"
LATTICE_REPLACES = ("none: tpu_pathopt/corridor.py (_build_lattice_geom, "
                    "prepare_lattice's nodes), tpu_pathopt/pipeline.py "
                    "(_refit_splines)")


def lattice_route(gm, scs, cfg) -> tuple:
    """(x, y, n_valid): the smoothed route the corridor stage refits."""
    prep = pipeline.stage_prep(scs, cfg)
    x, y, _, n, _ = pipeline.stage_smooth(gm, prep, cfg, cfg.qp_settings())
    return x, y, n


def lattice_work(gm, B, S, cfg) -> tuple[int, int]:
    """(bytes, float operations) of K6: the route and start read once, the
    ESDF's stencil table whole, every output written once; the refit
    (about 40 a knot), the pre-scan (about 30 a candidate), the Newton
    steps (about 40 each), the layers (about 60 each) and the nodes
    (about 30 each: the offset, the bilinear read, the rule, the bounds)."""
    L, K = cfg.dp_layers, cfg.dp_laterals
    ins = B * (2 * S * 4 + 8 + 2 * 4) + gm.quad.numel() * 4
    outs = (B * ((7 * S - 6 + 1) * 4 + (6 * L + 2) * 4 + 17
                 + L * K * (5 * 4 + 1)) + K * 4)
    flops = B * (40 * S + 30 * 256 + 40 * cfg.newton_iters + 60 * L
                 + 30 * L * K)
    return ins + outs, flops


def check_lattice(gm, scs) -> dict:
    """K6 against its plain chain on the card at LATTICE_SHAPES, every
    output bit for bit; each timed (``ms``: device time, the stream held
    busy; ``call_ms``: as the host issues it) beside its bound, its chain
    (the refit's two Thomas passes and float64 sum over S, the Newton
    steps) and the plain chain's time. Returns the lines by shape."""
    rows = {}
    for b, knobs in LATTICE_SHAPES:
        cfg = PlannerConfig(**knobs)
        sub = tree_map(lambda a, b=b: a[:b], scs)
        x, y, n = lattice_route(gm, sub, cfg)

        def kernel():
            return corridor.refit_lattice_kernel(gm, x, y, n, sub.start_x,
                                                 sub.start_y, cfg)
        got = kernel()
        want = corridor.refit_lattice_plain(gm, x, y, n, sub.start_x,
                                            sub.start_y, cfg)
        torch.cuda.synchronize()
        unequal = bit_unequal(got, want)
        ms = cuda_time_ms(kernel)
        call_ms = cuda_time_ms(kernel, hold=False)
        plain_ms = cuda_time_ms(
            lambda: corridor.refit_lattice_plain(gm, x, y, n, sub.start_x,
                                                 sub.start_y, cfg),
            reps=SLOW_PLAIN_REPS, warmup=1)
        S = x.shape[-1]
        nbytes, flops = lattice_work(gm, b, S, cfg)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        steps = 3 * S + cfg.newton_iters
        shape = f"B={b},K={cfg.dp_laterals}"
        line = dict(phase="kernel", name="lattice", shape=shape,
                    held=True, bit_equal=not unequal, unequal=unequal,
                    ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    plain_reps=SLOW_PLAIN_REPS, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    chain_steps=steps, ns_per_chain_step=ms * 1e6 / steps,
                    plan=list(corridor.lattice_plan(S, cfg.dp_layers,
                                                    cfg.dp_laterals)))
        emit(line)
        if unequal:
            raise AssertionError(f"lattice [{shape}] differs from the plain "
                                 f"chain: {unequal}")
        rows[shape] = line
    # Past the plan's limits a CUDA input raises before any launch.
    before = dict(kernels.launches)
    try:
        corridor.refit_lattice_kernel(gm, x, y, n, sub.start_x, sub.start_y,
                                      dataclasses.replace(
                                          cfg, dp_laterals=301))
    except ValueError as err:
        emit(dict(phase="kernel", name="lattice", shape="past_limit",
                  raised=str(err)))
    else:
        raise AssertionError("lattice: a plan past its limits launched")
    if kernels.launches != before:
        raise AssertionError("lattice: a refused plan counted a launch")
    return rows


# ------------------------------- K7, prep ------------------------------------

# K7 replaces no Pallas kernel: the prep stage's B-spline fit and 1 m
# segmentation (tpu_pathopt/bspline.py's fit_and_sample and
# tpu_pathopt/smoothing/segment.py's segment_raw_reference, XLA code). It
# is checked and timed at the main path's shapes, B 256 and B 1 (R 16, T
# 256, P 64), beside the plain chain on the card.
PREP_BATCHES = (256, 1)
PREP_SOURCE = "tpu_pathopt_torch/csrc/prep.cu"
PREP_REPLACES = ("none: tpu_pathopt/bspline.py (fit_and_sample), "
                 "tpu_pathopt/smoothing/segment.py (segment_raw_reference)")


def prep_work(B, R, cfg) -> tuple[int, int]:
    """(bytes, float operations) of K7: the raw points read once, every
    output written once; the length (about 20 a raw segment), the samples
    (about 12 a de Boor step, at most 15 steps of degree 5), the arc length
    and the fit (about 30 a sample) and the stations (about 40 each)."""
    T, P = cfg.bspline_samples, cfg.n_segment_points
    nbytes = B * (2 * R * 4 + 8) + B * (5 * P * 4 + 8 + 1)
    flops = B * (20 * R + T * (12 * 15 + 30) + 40 * P)
    return nbytes, flops


def check_prep(scs, cfg) -> dict:
    """K7 against its plain chain on the card at PREP_BATCHES, every
    output bit for bit; each timed (``ms``: device time, the stream held
    busy; ``call_ms``: as the host issues it) beside its bound, its chain
    (the float64 arc-length sum and the two Thomas passes over the T
    samples) and the plain chain's time. Returns the lines by shape."""
    rows = {}
    for b in PREP_BATCHES:
        sub = tree_map(lambda a, b=b: a[:b], scs)
        got = pipeline.prep_kernel(sub, cfg)
        want = pipeline._prep_plain(sub, cfg)
        torch.cuda.synchronize()
        unequal = bit_unequal(got, want)
        ms = cuda_time_ms(lambda: pipeline.prep_kernel(sub, cfg))
        call_ms = cuda_time_ms(lambda: pipeline.prep_kernel(sub, cfg),
                               hold=False)
        plain_ms = cuda_time_ms(lambda: pipeline._prep_plain(sub, cfg),
                                reps=SLOW_PLAIN_REPS, warmup=1)
        R = sub.raw_x.shape[1]
        nbytes, flops = prep_work(b, R, cfg)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        steps = 3 * cfg.bspline_samples
        line = dict(phase="kernel", name="prep", shape=f"B={b}",
                    held=True, bit_equal=not unequal, unequal=unequal,
                    ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    plain_reps=SLOW_PLAIN_REPS, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    chain_steps=steps, ns_per_chain_step=ms * 1e6 / steps,
                    plan=list(pipeline.prep_plan(R, cfg.bspline_samples,
                                                 cfg.n_segment_points)))
        emit(line)
        if unequal:
            raise AssertionError(f"prep [B={b}] differs from the plain "
                                 f"chain: {unequal}")
        rows[f"B={b}"] = line
    # Past the plan's limits a CUDA input raises before any launch.
    before = dict(kernels.launches)
    try:
        pipeline.prep_kernel(sub, dataclasses.replace(
            cfg, bspline_samples=pipeline.PREP_MAX_SAMPLES + 1))
    except ValueError as err:
        emit(dict(phase="kernel", name="prep", shape="past_limit",
                  raised=str(err)))
    else:
        raise AssertionError("prep: a plan past its limits launched")
    if kernels.launches != before:
        raise AssertionError("prep: a refused plan counted a launch")
    return rows


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


def timed_solve(gm, scs, cfg, device="cuda", settings=None):
    """One solve_batch with CUDA events between its stages: (result, wall
    seconds, ms by stage, rounds)."""
    marks, stats = [], {}

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.solve_batch(gm, scs, cfg, settings, device=device,
                               stats=stats, hook=hook)
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


def drive_variants(gm, scs, cfg, device="cuda", results=None) -> dict:
    """solve_batch under each of VARIANTS on the batch: the first run
    counted (launch counters set to 0 just before, read just after), then
    REPEATS - 1 more; stage times and solves/s are medians over all. Each
    variant's result, rounds and launches by key are kept in ``results``
    (for the compiled phase)."""
    out = {}
    for name, kw in VARIANTS.items():
        vcfg = dataclasses.replace(cfg, **kw)
        kernels.reset_launches()
        res, wall, stage_ms, stats = timed_solve(gm, scs, vcfg, device)
        launches = dict(kernels.launches)
        by_shape = dict(kernels.shape_launches)
        check_outputs(res, vcfg)
        if results is not None:
            results[name] = (res, stats, by_shape)
        walls, stages = [wall], [stage_ms]
        for _ in range(REPEATS - 1):
            _, w, s, _ = timed_solve(gm, scs, vcfg, device)
            walls.append(w)
            stages.append(s)
        ok_fraction = float(res.ok.float().mean())
        rows_vary = rows_vary_by_knot(gm, scs, vcfg) if name == "rough" \
            else None
        report = dict(
            phase="variants", variant=name, config=kw, batch=len(res.ok),
            seconds_runs=walls, solves_per_s=len(res.ok)
            / statistics.median(walls), ok_fraction=ok_fraction,
            stage_ms={k: statistics.median(s[k] for s in stages)
                      for k in stage_ms},
            rounds=stats, mean_qp_iters=float(res.qp_iters.float().mean()),
            launches=launches, shape_launches=by_shape,
            collision=collision_report(gm, res, vcfg, device),
            rows_vary_by_knot=rows_vary)
        emit(report)
        if ok_fraction != 1.0:
            raise AssertionError(f"{name}: ok_fraction {ok_fraction} != 1.0")
        if rows_vary is False:
            raise AssertionError(f"{name}: the pass-1 path QP's collision "
                                 "rows are the same at every knot")
        need = VARIANT_KEYS.get(name, [])
        idle = [k for k in ("fused_factor", "fused_admm_round",
                            "fused_structured_round") if not launches[k]]
        idle += [k for k in need if not by_shape.get(k)]
        if idle:
            raise AssertionError(f"{name}: launched no {idle}")
        if name == "astar" and (launches["dp_forward"]
                                or launches["lattice"]):
            raise AssertionError("astar: the DP kernels K4 or K6 launched")
        out[name] = report
    return out


def rows_vary_by_knot(gm, scs, cfg) -> bool:
    """Whether the collision rows K2 takes differ by knot in the pass-1
    path QP of ``cfg`` on the batch (the stages run eagerly, then one
    read): what the rough far-away rows change."""
    _, _, geo, _, _ = stages(gm, scs, cfg)
    rows = fused_rounds.collision_rows(
        pipeline.build_path_qp(scs, geo, cfg).coll_coef)
    return not bool((rows == rows[:1]).all())


def drive_replan(gm, scs, cfg, device="cuda") -> dict:
    """replan_stream on the batch, warm and cold: a 1-cycle stream of each
    to warm up, then REPLAN_CYCLES cycles of each, its kernel launches
    counted; and solve_batch_profiled's compiled stages
    (:func:`profiled_stages`)."""
    streams, launches = {}, {}
    for mode in ("warm", "cold"):
        use_warm = mode == "warm"
        replan.replan_stream(gm, scs, cfg, n_steps=1, use_warm=use_warm,
                             device=device)
        kernels.reset_launches()
        streams[mode] = dataclasses.asdict(replan.replan_stream(
            gm, scs, cfg, n_steps=REPLAN_CYCLES, advance_ds=1.0,
            use_warm=use_warm, device=device))
        kernels.sync_counts()
        launches[mode] = dict(kernels.launches)
    w, c = streams["warm"], streams["cold"]
    report = dict(phase="replan", batch=len(scs.n_raw), advance_ds=1.0,
                  cycles=REPLAN_CYCLES, warm=w, cold=c,
                  iters_rest_warm_over_cold=w["mean_iters_rest"]
                  / c["mean_iters_rest"], launches=launches,
                  **profiled_stages(gm, scs, cfg, device))
    emit(report)
    if report["profiled_faults"]:
        raise AssertionError("profiled stages: "
                             + "; ".join(report["profiled_faults"]))
    for mode, st in streams.items():
        if st["n_ok"] != st["n_total"]:
            raise AssertionError(f"replan {mode}: {st['n_ok']} of "
                                 f"{st['n_total']} solves ok")
    if w["mean_iters_rest"] > c["mean_iters_rest"]:
        raise AssertionError("replan: the warm cycles iterate more than the "
                             "cold ones")
    return report


# The stages solve_batch_profiled records, under the JAX package's names
# (tpu_pathopt/pipeline.py), and each stage key's conditional nodes: a WHILE
# and an IF node for each QP solve of the stage.
PROFILED_STAGES = {"prep": 0, "smooth": 2, "corridor": 0, "post_smooth": 2,
                   "bounds": 0, "path_qp": 4, "finalize": 0}


def profiled_stages(gm, scs, cfg, device="cuda") -> dict:
    """solve_batch_profiled, each stage a compiled call of its own
    (``pipeline.STAGES``): one untimed call that captures the stage keys,
    then a recorded call (``profiled_stage_ms``: each stage's replay and
    the waits around it), beside the eager stage times of the same
    recorder around solve_batch (``eager_stage_ms``) and the sum of the
    stages beside one solve_batch_jit replay; a call with ``stats``, its
    result bit for bit solve_batch's and its rounds equal; and a call under
    :class:`HostReads`. Each stage key: one graph, its conditional nodes
    (PROFILED_STAGES), capture s and pool bytes."""
    pipeline.STAGES.clear()
    t0 = time.perf_counter()
    pipeline.solve_batch_profiled(gm, scs, cfg, recorder=profiling.
                                  TimeRecorder("capture"), device=device)
    first_s = time.perf_counter() - t0
    rec = profiling.TimeRecorder("profiled")
    pipeline.solve_batch_profiled(gm, scs, cfg, recorder=rec, device=device)
    eager_rec = profiling.TimeRecorder("eager")
    want_stats = {}
    want = pipeline.solve_batch(gm, scs, cfg, device=device,
                                stats=want_stats,
                                hook=lambda n: eager_rec.record(
                                    n, block_on=gm))
    stats = {}
    got = pipeline.solve_batch_profiled(gm, scs, cfg, recorder=profiling.
                                        TimeRecorder("stats"),
                                        device=device, stats=stats)
    _, reads = host_reads(lambda: pipeline.solve_batch_profiled(
        gm, scs, cfg, recorder=profiling.TimeRecorder("reads"),
        device=device))
    pipeline.solve_batch_jit(gm, scs, cfg, device=device)
    sync(device)
    t0 = time.perf_counter()
    pipeline.solve_batch_jit(gm, scs, cfg, device=device)
    sync(device)
    jit_ms = 1e3 * (time.perf_counter() - t0)
    stage_ms = rec.stage_ms()
    keys = {key[0][0]: graph_report(segs)
            for key, segs in pipeline.STAGES.entries.items()}
    faults = []
    if list(stage_ms) != list(PROFILED_STAGES) or list(keys) != list(
            PROFILED_STAGES):
        faults.append(f"stages {list(stage_ms)}, keys {list(keys)}")
    for name, graph in keys.items():
        if graph["capture"] and (graph["graphs"] != 1 or graph[
                "conditional_nodes"] != PROFILED_STAGES.get(name)):
            faults.append(f"{name}: graph {graph}")
    if device == "cuda" and reads:
        faults.append(f"{reads} host reads in a profiled call")
    unequal = bit_unequal(got, want)
    if unequal or stats != want_stats:
        faults.append(f"differs from solve_batch in {unequal}, rounds "
                      f"{stats} != {want_stats}")
    return dict(profiled_stage_ms=stage_ms,
                profiled_stage_ms_sum=sum(stage_ms.values()),
                profiled_first_call_s=first_s,
                eager_stage_ms=eager_rec.stage_ms(),
                eager_stage_ms_sum=sum(eager_rec.stage_ms().values()),
                jit_replay_ms=jit_ms, profiled_stage_keys=keys,
                profiled_host_reads_per_call=reads, profiled_rounds=stats,
                eager_rounds=want_stats, profiled_unequal=unequal,
                profiled_faults=faults, nvidia_smi=card_line())


def drive_main_path(gm, scs, cfg, device="cuda",
                    results=None) -> tuple[dict, dict]:
    """One counted, timed solve_batch on the card; returns (report,
    launches). The result, rounds and launches by key are kept in
    ``results["main"]``."""
    kernels.reset_launches()
    res, wall, stage_ms, stats = timed_solve(gm, scs, cfg, device)
    launches = dict(kernels.launches)
    by_shape = dict(kernels.shape_launches)
    check_outputs(res, cfg)
    if results is not None:
        results["main"] = (res, stats, by_shape)
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
                  launches=launches, shape_launches=by_shape,
                  permuted=permuted_batch(gm, scs, cfg, res, device))
    emit(report)
    if ok_fraction != 1.0:
        raise AssertionError(f"ok_fraction {ok_fraction} != 1.0")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"the main path launched no {idle}")
    clustered = [k for k in by_shape if k.startswith("fused_")
                 and ",c=" in k and not k.endswith(",c=1]")]
    if clustered:
        raise AssertionError(f"the default config launched clusters: "
                             f"{clustered}")
    if report["permuted"]["unequal"]:
        raise AssertionError(f"permuted batch: {report['permuted']}")
    return report, launches


def permuted_batch(gm, scs, cfg, res, device="cuda") -> dict:
    """The batch solved again in a seeded random order (after the counted
    run): flags and counts must equal ``res``'s once un-permuted; the
    paths' largest difference is reported, and whether they are equal bit
    for bit (each scenario's lane does not depend on its place in the
    batch)."""
    perm = torch.as_tensor(np.random.default_rng(11).permutation(
        len(res.ok)), device=res.ok.device)
    inv = torch.argsort(perm)
    got = pipeline.solve_batch(gm, tree_map(lambda a: a[perm], scs), cfg,
                               device=device)
    unequal = [f for f in golden.FLAG_FIELDS + golden.COUNT_FIELDS
               if not torch.equal(getattr(got, f)[inv], getattr(res, f))]
    m = res.mask
    diff = {f: float((getattr(got, f)[inv] - getattr(res, f)).abs()[m].max())
            for f in golden.PATH_FIELDS}
    return dict(unequal=unequal, max_abs_diff=diff,
                bit_equal=all(torch.equal(getattr(got, f)[inv],
                                          getattr(res, f))
                              for f in golden.PATH_FIELDS))


# The geometry stage on the card against the same stage on the CPU, fed the
# same inputs (check_card_geometry): tests/test_torch_stages.py's
# tolerances for the geometry stage's reference (metres, radians, 1/m) and
# bounds (one 0.05 m clearance-march step), and n_valid exactly.
GEOMETRY_TOL = {"x": 2e-2, "y": 2e-2, "heading": 2e-3, "k": 5e-4,
                "bounds": 0.05 + 2e-3}


def geometry_arrays(geo) -> dict:
    """stage_geometry's output as numpy arrays: the reference, the front
    and rear bounds, n_valid."""
    ref, cb = geo[0], geo[1]
    out = {f: getattr(ref, f) for f in ("x", "y", "heading", "k")}
    out.update({f: getattr(cb, f) for f in golden.BOUND_FIELDS})
    out["n_valid"] = geo[-1]
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_card_geometry(device="cuda") -> dict:
    """pipeline.stage_geometry at scenarios.STRETCH_CONFIG on the five
    lanes of inputs the card once turned NaN (golden.card_geometry), on
    ``device`` and on the CPU: every lane's reference finite on its valid
    knots, n_valid equal, the reference and bounds within GEOMETRY_TOL; on
    the card the stage is K5, held there bit for bit to the plain chain
    (``pipeline._geometry_plain``). Before the geometry stage's refit summed
    the arc length in float64 the card's float32 sum made a zero knot
    interval on every one of these lanes (n_valid 0, the reference NaN)."""
    cfg = PlannerConfig(**scenarios.STRETCH_CONFIG)
    out = {}
    for dev in (device, "cpu"):
        d = golden.card_geometry(dev)
        args = (d["gm"], d["scs"], d["xs2"], d["ys2"], d["cor"], d["l_post"])
        out[dev] = geometry_arrays(pipeline.stage_geometry(*args, cfg))
        if dev == device:
            card_plain = geometry_arrays(pipeline._geometry_plain(*args, cfg))
    got, want = out[device], out["cpu"]
    plain_unequal = [f for f in got if not np.array_equal(
        got[f], card_plain[f], equal_nan=f != "n_valid")]
    n = np.minimum(got["n_valid"], want["n_valid"])
    mask = np.arange(cfg.n_knots)[None] < n[:, None]
    finite = [bool(np.isfinite(got[f][i][mask[i]]).all()
                   for f in ("x", "y", "heading", "k"))
              for i in range(len(n))]
    diffs = {f: float(np.where(mask, np.abs(got[f].astype(np.float64)
                                            - want[f]), 0.0).max())
             for f in got if f != "n_valid"}
    report = dict(phase="long_route", run="card_geometry",
                  lanes=d["lane"].tolist(), rounds=d["run"].tolist(),
                  n_valid=got["n_valid"].tolist(),
                  n_valid_cpu=want["n_valid"].tolist(), finite=finite,
                  max_abs_diff=diffs, unequal_to_card_plain=plain_unequal)
    emit(report)
    bad = [f for f, v in diffs.items()
           if not v <= GEOMETRY_TOL.get(f, GEOMETRY_TOL["bounds"])]
    if (not all(finite) or bad or plain_unequal or (got["n_valid"] == 0).any()
            or not np.array_equal(got["n_valid"], want["n_valid"])):
        raise AssertionError(f"card_geometry: {report}")
    return report


# The long route's runs in the long_route phase: (name, PlannerConfig
# keyword arguments, plain rounds, timed runs, launch keys that must show,
# horizon). A K2 key must show a cluster (c > 1). The plain rounds
# (QPSettings(fused_rounds=False)) take seconds a launch at these sizes, so
# that run is timed once. Horizon "whole": no lane but the blocked one
# stops short of its target (horizon_truncated); "cut": 300 knots of 0.3 m
# hold 90 m of the 120 m routes, so every lane is truncated at its last
# knot, as the JAX package's are (tests/test_torch_long_horizon.py).
LONG_RUNS = (
    ("long", scenarios.LONG_CONFIG, False, REPEATS,
     ["fused_admm_round[nb=6,N=512,c="], "whole"),
    ("long_rough", dict(scenarios.LONG_CONFIG, **VARIANTS["rough"]), False,
     REPEATS, ["fused_admm_round[nb=6,N=512,c="], "whole"),
    ("stretch", scenarios.STRETCH_CONFIG, False, REPEATS,
     ["fused_structured_round[nb=4,r=3,N=384,c=2]",
      "fused_structured_round[nb=3,r=3,N=300,c=2]"], "whole"),
    ("stretch_plain", scenarios.STRETCH_CONFIG, True, 1, [], "whole"),
    ("n_knots_300", dict(scenarios.LONG_CONFIG, n_knots=300), False, REPEATS,
     ["fused_admm_round[nb=6,N=300,c=2]"], "cut"),
    ("n_knots_1024", dict(scenarios.LONG_CONFIG, n_knots=1024), False,
     REPEATS, ["fused_admm_round[nb=6,N=1024,c=4]"], "whole"),
)


def drive_long_route(gm, scs, gm_adv, scs_adv, device="cuda",
                     results=None) -> dict:
    """The long route's 256 scenarios under each of LONG_RUNS (at 512
    knots, the same under the rough far-away rows, at 384 segment points
    with the kernels and with the plain rounds, at 300 and 1024 knots),
    and the fine lattice (FINE_LATTICE) on the adversarial batch, each
    solved to the end and counted as the main path is (launch counters set
    to 0 just before the first run, read just after), and timed over its
    runs. Each must reach ok_fraction 1.0 with every path finite on its
    valid knots and every succeeded path collision free; each long-route
    run must meet its LONG_RUNS horizon and launch its LONG_RUNS keys; the
    fine lattice must launch K4 at 135 laterals. First the geometry stage
    on the card's captured inputs (check_card_geometry). Each run's result,
    rounds and launches by key are kept in ``results``."""
    runs = [(name, gm, scs, kw, PlannerConfig(**kw), plain, reps, need,
             horizon)
            for name, kw, plain, reps, need, horizon in LONG_RUNS]
    runs.append(("fine_lattice", gm_adv, scs_adv, FINE_LATTICE,
                 PlannerConfig(**FINE_LATTICE), False, REPEATS,
                 [f"dp_forward[K={FINE_LATTICE['dp_laterals']},"], None))
    out = {"card_geometry": check_card_geometry(device)}
    for name, g, sc, kw, c, plain, reps, need, horizon in runs:
        settings = c.qp_settings(fused_rounds=False) if plain else None
        kernels.reset_launches()
        res, wall, stage_ms, stats = timed_solve(g, sc, c, device, settings)
        launches = dict(kernels.launches)
        by_shape = dict(kernels.shape_launches)
        check_outputs(res, c)
        if results is not None:
            results[name] = (res, stats, by_shape)
        walls, stages = [wall], [stage_ms]
        for _ in range(reps - 1):
            _, w, st, _ = timed_solve(g, sc, c, device, settings)
            walls.append(w)
            stages.append(st)
        per = len(res.ok) // len(scenarios.LANES)
        lanes = {lane: res.n_valid[i * per:(i + 1) * per]
                 for i, lane in enumerate(scenarios.LANES)}
        unblocked = slice(0, per * scenarios.LANES.index("blocked"))
        report = dict(
            phase="long_route", run=name, config=kw, plain_rounds=plain,
            batch=len(res.ok),
            n_knots=c.n_knots, seconds_runs=walls,
            solves_per_s=len(res.ok) / statistics.median(walls),
            ok_fraction=float(res.ok.float().mean()),
            stage_ms={k: statistics.median(st[k] for st in stages)
                      for k in stage_ms},
            rounds=stats, mean_qp_iters=float(res.qp_iters.float().mean()),
            n_valid={k: [int(v.min()), int(v.max())]
                     for k, v in lanes.items()},
            truncated=int(res.horizon_truncated.sum()),
            truncated_unblocked=int(res.horizon_truncated[unblocked].sum()),
            launches=launches, shape_launches=by_shape,
            plans={k: v for k, v in by_shape.items() if ",c=" in k},
            collision=collision_report(g, res, c, device),
            nvidia_smi=card_line())
        emit(report)
        if report["ok_fraction"] != 1.0:
            raise AssertionError(f"{name}: ok_fraction "
                                 f"{report['ok_fraction']}")
        col = report["collision"]
        if col["n_ok_collision_free"] != col["n_ok"]:
            raise AssertionError(f"{name}: {col}")
        if horizon == "whole" and report["truncated_unblocked"]:
            raise AssertionError(f"{name}: {report['truncated_unblocked']} "
                                 "scenarios off the blocked lane truncated")
        if horizon == "cut" and not (bool(res.horizon_truncated.all()) and
                                     bool((res.n_valid == c.n_knots).all())):
            raise AssertionError(f"{name}: {report['truncated']} scenarios "
                                 f"truncated, n_valid {report['n_valid']}")
        for prefix in need:
            hits = [k for k in by_shape if k.startswith(prefix)]
            if not hits or (prefix.startswith("fused_admm_round")
                            and all(k.endswith(",c=1]") for k in hits)):
                raise AssertionError(f"{name}: no launch {prefix}..., "
                                     f"{by_shape}")
        out[name] = report
    return out


# ------------------------------ compiled path --------------------------------

def fields(obj, prefix="") -> dict:
    """Every tensor of a result (nested dataclasses and tuples) by its
    dotted field name."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    elif isinstance(obj, (tuple, list)):
        items = ((str(i), o) for i, o in enumerate(obj))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(fields(v, f"{prefix}.{k}" if prefix else k))
    return out


def bit_unequal(got, want) -> list:
    """The fields of two results that differ in any bit (NaN equal to the
    same NaN), or in dtype or shape."""
    fg, fw = fields(got), fields(want)
    bad = sorted(set(fg) ^ set(fw))
    for k in sorted(set(fg) & set(fw)):
        a, b = fg[k], fw[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(k)
            continue
        if a.dtype.is_floating_point:
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                a.element_size()]
            a, b = a.reshape(-1).view(bits), b.reshape(-1).view(bits)
        if not torch.equal(a, b):
            bad.append(k)
    return bad


def without_rounds(sol):
    """A solution without its round count (an int eager, a device tensor
    from a compiled call; the rounds are compared on their own), or a trace
    as it is."""
    return (dataclasses.replace(sol, rounds=0)
            if dataclasses.is_dataclass(sol) else sol)


def last_segments():
    """The compiled-call cache entry used last (its Segments)."""
    return next(reversed(pipeline.COMPILED.entries.values()))


def pool_bytes(segs) -> int | None:
    """Bytes the caching allocator holds in a key's graph memory pool
    (every segment's temporaries and results), from the memory snapshot;
    None where the snapshot does not name pools."""
    snap = torch.cuda.memory_snapshot()
    if not snap or "segment_pool_id" not in snap[0]:
        return None
    pid = tuple(segs.pool)
    return sum(s["total_size"] for s in snap
               if tuple(s["segment_pool_id"]) == pid)


class HostReads(TorchDispatchMode):
    """Counts the host reads the operations it sees make: a scalar read
    (``item``, ``bool``, ``int``), a copy from the device to the host, a
    comparison or a selection whose answer the host needs."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.equal.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in self.READS:
            self.n += 1
        elif func in (torch.ops.aten._to_copy.default,
                      torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else args[0]
            dst = out
            if (isinstance(src, torch.Tensor) and src.is_cuda
                    and isinstance(dst, torch.Tensor) and not dst.is_cuda):
                self.n += 1
        return out


def host_reads(fn) -> tuple:
    """(fn(), the host reads it made)."""
    with HostReads() as mode:
        out = fn()
    return out, mode.n


def graph_report(segs) -> dict:
    """A key's graph: how many (one per key), its conditional nodes (a
    WHILE and an IF for each QP solve), capture seconds and pool bytes."""
    return dict(capture=segs.capture, graphs=int(segs.graph is not None),
                conditional_nodes=segs.conditional_nodes,
                qp_loops=len(segs.loops), capture_s=segs.capture_seconds,
                pool_bytes=pool_bytes(segs) if segs.capture else None)


def graph_faults(name, graph, host_reads_per_call, rounds, want_rounds,
                 by_shape, want_shape) -> list:
    """The device-loop checks of a compiled run: one graph with a WHILE
    and an IF node for each QP loop and no host read inside the call (on
    the card; on the CPU a read a round stands in for the nodes), the
    device's round counts and the launches by key equal the eager call's."""
    bad = []
    if graph["capture"] and (
            graph["graphs"] != 1 or not graph["qp_loops"]
            or graph["conditional_nodes"] != 2 * graph["qp_loops"]):
        bad.append(f"graph {graph}")
    if graph["capture"] and host_reads_per_call:
        bad.append(f"{host_reads_per_call} host reads inside the call")
    if rounds != want_rounds:
        bad.append(f"rounds {rounds} != eager {want_rounds}")
    if by_shape != want_shape:
        bad.append(f"launches {by_shape} != eager {want_shape}")
    return [f"compiled {name}: {b}" for b in bad]


def compiled_run(name, gm, scs, cfg, want, device="cuda") -> dict:
    """solve_batch_jit on one configuration: the first call (warm-up and
    capture of the key's one graph, then its replay), then REPEATS
    replays, the first of them counted (launch counters set to 0 just
    before; the device's launch and round counts read just after, outside
    the timed call), and one more call under :class:`HostReads`. ``want``
    is solve_batch's (result, rounds, launches by key) on the same
    inputs: every field of both results must equal it bit for bit, and
    the rounds and launches by key the device counted must equal its;
    ok_fraction must be 1.0, every succeeded path finite and collision
    free, and no host read made inside the call."""
    want, want_rounds, want_shape = want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pipeline.solve_batch_jit(gm, scs, cfg, device=device)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    segs = last_segments()
    replay = []
    for i in range(REPEATS):
        if i == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipeline.solve_batch_jit(gm, scs, cfg, device=device)
        torch.cuda.synchronize()
        replay.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            rounds = {f"{k}_rounds": v for k, v in segs.sync().items()}
            launches = dict(kernels.launches)
            by_shape = dict(kernels.shape_launches)
    _, reads = host_reads(lambda: pipeline.solve_batch_jit(
        gm, scs, cfg, device=device))
    check_outputs(res, cfg)
    ms = statistics.median(replay)
    graph = graph_report(segs)
    report = dict(
        phase="compiled", run=name, batch=len(res.ok), n_knots=cfg.n_knots,
        first_call_s=first_s, replay_ms_runs=replay, replay_ms=ms,
        solves_per_s=len(res.ok) / ms * 1e3,
        ok_fraction=float(res.ok.float().mean()), **graph,
        host_reads_per_call=reads, rounds=rounds, eager_rounds=want_rounds,
        launches=launches, shape_launches=by_shape,
        launches_equal_eager=by_shape == want_shape,
        unequal_first=bit_unequal(first, want),
        unequal_replay=bit_unequal(res, want),
        collision=collision_report(gm, res, cfg, device),
        nvidia_smi=card_line())
    emit(report)
    if report["unequal_first"] or report["unequal_replay"]:
        raise AssertionError(f"compiled {name}: differs from solve_batch in "
                             f"{report['unequal_first']} / "
                             f"{report['unequal_replay']}")
    if report["ok_fraction"] != 1.0:
        raise AssertionError(f"compiled {name}: ok_fraction "
                             f"{report['ok_fraction']}")
    col = report["collision"]
    if col["n_ok_collision_free"] != col["n_ok"]:
        raise AssertionError(f"compiled {name}: {col}")
    idle = [k for k in ("fused_factor", "fused_admm_round",
                        "fused_structured_round") if not launches[k]]
    if cfg.corridor_method == "DP" and not launches["dp_forward"]:
        idle.append("dp_forward")
    if idle:
        raise AssertionError(f"compiled {name}: no {idle} on replay")
    bad = graph_faults(name, graph, reads, rounds, want_rounds, by_shape,
                       want_shape)
    if bad:
        raise AssertionError("; ".join(bad))
    return report


def eager_record(gm, scs, cfg, device="cuda", **kw):
    """solve_batch (``kw``: the warm start) as (result, rounds, launches
    by key); counted, the counters reset before."""
    stats = {}
    kernels.reset_launches()
    out = pipeline._solve_batch_impl(gm, scs, cfg, None, device, stats=stats,
                                     **kw)
    return out, stats, dict(kernels.shape_launches)


def compiled_replan(gm, scs, cfg, device="cuda") -> dict:
    """REPLAN_COMPILED_CYCLES cycles of the compiled replan_step (the
    first captures, the others replay) against the eager cycle, each
    cycle's result, warm state and advanced poses bit for bit; the last
    cycle counted, its device round and launch counts against the eager
    cycle's, and one more cycle on its inputs under :class:`HostReads`."""
    B = len(scs.n_raw)
    warm_e = warm_c = pipeline.QPWarmStart.cold(B, cfg, device)
    scs_e = scs_c = scs
    unequal, cycle_ms = [], []
    for c in range(REPLAN_COMPILED_CYCLES):
        (res_e, warm_o), want_rounds, want_shape = eager_record(
            gm, scs_e, cfg, device, warm=warm_e, return_warm=True)
        want = (res_e, warm_o, replan.advance_scenarios(scs_e, res_e, 1.0))
        last = c == REPLAN_COMPILED_CYCLES - 1
        if last:
            kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = replan.replan_step(gm, scs_c, warm_c, cfg, None, 1.0,
                                 device=device)
        torch.cuda.synchronize()
        cycle_ms.append(1e3 * (time.perf_counter() - t0))
        segs = last_segments()
        if last:
            rounds = {f"{k}_rounds": v for k, v in segs.sync().items()}
            launches = dict(kernels.launches)
            by_shape = dict(kernels.shape_launches)
            _, reads = host_reads(lambda: replan.replan_step(
                gm, scs_c, warm_c, cfg, None, 1.0, device=device))
        unequal += [f"c{c}.{k}" for k in bit_unequal(got, want)]
        _, warm_e, scs_e = want
        _, warm_c, scs_c = got
    res = got[0]
    graph = graph_report(segs)
    report = dict(phase="compiled", run="replan", batch=B,
                  cycles=REPLAN_COMPILED_CYCLES, cycle_ms=cycle_ms,
                  replay_ms=statistics.median(cycle_ms[1:]),
                  solves_per_s=B / statistics.median(cycle_ms[1:]) * 1e3,
                  ok_fraction=float(res.ok.float().mean()), **graph,
                  host_reads_per_call=reads, rounds=rounds,
                  eager_rounds=want_rounds, launches=launches,
                  shape_launches=by_shape,
                  launches_equal_eager=by_shape == want_shape,
                  unequal=unequal, nvidia_smi=card_line())
    emit(report)
    if unequal:
        raise AssertionError(f"compiled replan: differs in {unequal}")
    if report["ok_fraction"] != 1.0:
        raise AssertionError(f"compiled replan: ok_fraction "
                             f"{report['ok_fraction']}")
    check_outputs(res, cfg)
    bad = graph_faults("replan", graph, reads, rounds, want_rounds, by_shape,
                       want_shape)
    if bad:
        raise AssertionError("; ".join(bad))
    return report


def compiled_two_inputs(gm, scs, cfg, device="cuda") -> dict:
    """Two input sets of one key, whose solves take different rounds: the
    adversarial batch and its easy lanes repeated to the same size, then
    the adversarial batch again, each through the one graph of the key and
    each bit for bit its own eager result, with its own eager rounds."""
    per = len(scs.n_raw) // len(scenarios.LANES)
    easy = tree_map(lambda a: a[:per].repeat(
        (len(scenarios.LANES),) + (1,) * (a.dim() - 1)), scs)
    runs, keys = [], set()
    for name, batch in (("adversarial", scs), ("easy", easy),
                        ("adversarial", scs)):
        want, want_rounds, want_shape = eager_record(gm, batch, cfg, device)
        kernels.reset_launches()
        got = pipeline.solve_batch_jit(gm, batch, cfg, device=device)
        segs = last_segments()
        keys.add(id(segs))
        rounds = {f"{k}_rounds": v for k, v in segs.sync().items()}
        runs.append(dict(batch=name, rounds=rounds, eager_rounds=want_rounds,
                         launches_equal_eager=dict(kernels.shape_launches)
                         == want_shape,
                         unequal=bit_unequal(got, want),
                         ok_fraction=float(got.ok.float().mean())))
    report = dict(phase="compiled", run="two_inputs", keys=len(keys),
                  **graph_report(segs), runs=runs, nvidia_smi=card_line())
    emit(report)
    bad = [r for r in runs if r["unequal"] or r["rounds"] != r["eager_rounds"]
           or not r["launches_equal_eager"] or r["ok_fraction"] != 1.0]
    if bad or len(keys) != 1 or runs[0]["rounds"] == runs[1]["rounds"]:
        raise AssertionError(f"compiled two_inputs: {runs}")
    return report


def compiled_stream(gm, scs, cfg, device="cuda") -> dict:
    """replan_stream (each cycle the compiled replan_step) over
    REPLAN_CYCLES cycles after a warm-up stream, timed against
    REPLAN_CYCLES single compiled replan_steps, each waited for; then once
    more under :class:`HostReads`: no host read while its cycles are
    issued (each ``consume`` call, made after the next cycle is issued,
    sees the count), its reads only at the end."""
    replan.replan_stream(gm, scs, cfg, n_steps=REPLAN_CYCLES, device=device)
    stats = replan.replan_stream(gm, scs, cfg, n_steps=REPLAN_CYCLES,
                                 device=device)
    seen = []
    mode = HostReads()
    with mode:
        replan.replan_stream(gm, scs, cfg, n_steps=REPLAN_CYCLES,
                             device=device,
                             consume=lambda r: seen.append(mode.n))
    reads_at_end = mode.n
    B = len(scs.n_raw)
    warm = pipeline.QPWarmStart.cold(B, cfg, device)
    sc = scs
    single_ms = []
    for _ in range(REPLAN_CYCLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, warm, sc = replan.replan_step(gm, sc, warm, cfg, None, 1.0,
                                         device=device)
        torch.cuda.synchronize()
        single_ms.append(1e3 * (time.perf_counter() - t0))
    report = dict(phase="compiled", run="replan_stream", batch=B,
                  cycles=REPLAN_CYCLES, stream_ms=1e3 * stats.seconds,
                  stream_ms_per_cycle=1e3 * stats.seconds / REPLAN_CYCLES,
                  single_ms=single_ms, single_ms_sum=sum(single_ms),
                  host_reads_while_issuing=seen, host_reads_total=reads_at_end,
                  n_ok=stats.n_ok, n_total=stats.n_total,
                  nvidia_smi=card_line())
    emit(report)
    # On the CPU each QP round reads its flags (no graph to hold the loop).
    if (device == "cuda" and any(seen)) or stats.n_ok != stats.n_total:
        raise AssertionError(f"compiled replan_stream: {report}")
    return report


def drive_compiled(gm, scs, cfg, gm_long, scs_long, eager: dict,
                   device="cuda") -> dict:
    """The compiled entry points on the card (``pipeline.solve_batch_jit``,
    the compiled ``replan.replan_step``): the adversarial batch at the
    default config and under every variant, two input sets of one key, the
    replanning cycles and stream, every long-route run of LONG_RUNS but
    the plain rounds and the fine lattice (FINE_LATTICE, K4 at 135
    laterals), each held bit for bit to the eager result of the same
    call (``eager``, from the earlier phases: result, rounds and launches
    by key). The sharded path is held in ``drive_dist``. Raises first
    unless the CUDA runtime and driver have conditional graph nodes."""
    kernels.require_conditional_nodes()
    out = {"main": compiled_run("main", gm, scs, cfg, eager["main"], device)}
    for name, kw in VARIANTS.items():
        out[name] = compiled_run(name, gm, scs, dataclasses.replace(
            cfg, **kw), eager[name], device)
    out["two_inputs"] = compiled_two_inputs(gm, scs, cfg, device)
    out["replan"] = compiled_replan(gm, scs, cfg, device)
    out["replan_stream"] = compiled_stream(gm, scs, cfg, device)
    for name, kw, plain, _, _, _ in LONG_RUNS:
        if plain:
            continue
        out[name] = compiled_run(name, gm_long, scs_long, PlannerConfig(**kw),
                                 eager[name], device)
        # The long route's pools are the largest: free each before the next.
        pipeline.COMPILED.clear()
    out["fine_lattice"] = compiled_run(
        "fine_lattice", gm, scs, PlannerConfig(**FINE_LATTICE),
        eager["fine_lattice"], device)
    pipeline.COMPILED.clear()
    return out


SOLVER_LANES = 4          # lanes of the scalar path solver and the traces
SOLVER_TRACE_ROUNDS = 8


def solver_cases(gm, scs, cfg) -> dict:
    """The seven compiled standalone solvers on the oracle families' own
    QPs (rebuilt through the stage functions, as ``qp_families`` builds
    them): run -> (solver, args, kwargs, conditional nodes of its graph,
    kernels it must launch). A solve with a refactor has a WHILE and an
    IF node, the scalar path solver (a select each round) a WHILE node;
    a trace's fixed rounds are a WHILE node on a device counter, the dense
    trace's refactor an IF node in it. The block-banded solver on TENSION2
    (K1, K3 at (4, 3)) and post (K3 at (3, 3)); the batched path solver on
    pass 2,
    warm-started from pass 1 as the pipeline starts it (K1, K2); the dense
    batched solver on the post QPs in float64 at the oracle's settings and
    on the dense builder's TENSION2 QPs in float32; the dense scalar
    solver and its trace on one lane; the scalar path solver and its trace
    on SOLVER_LANES lanes of pass 1."""
    st = cfg.qp_settings()
    prep, cor, geo, sol1, _ = stages(gm, scs, cfg)
    _, xg, yg, sg, ang, kg, n_seg = prep
    t2 = build_tension2_structured(xg, yg, ang, kg, sg, n_seg, cfg)
    post = build_post_structured(cor.layers_s, cor.lower, cor.upper,
                                 cor.vehicle_l, cor.n_layers, cfg)
    post32 = structured.to_dense(post)
    post64 = tuple(a.double() for a in post32)
    few = tree_map(lambda a: a[:SOLVER_LANES],
                   pipeline.build_path_qp(scs, geo, cfg))
    lane0 = lambda dense: tuple(a[0] for a in dense)  # noqa: E731
    k13 = ("fused_factor", "fused_structured_round")
    trace = dict(settings=st, n_rounds=SOLVER_TRACE_ROUNDS)
    return {
        "structured_tension2": (structured.solve_structured_batched, (t2,),
                                dict(settings=st), 2, k13),
        "structured_post": (structured.solve_structured_batched, (post,),
                            dict(settings=st), 2, k13),
        "path_batched_pass2": (
            path_solver.solve_path_qp_batched,
            (pipeline.build_path_qp(scs, geo, cfg, sol1=sol1),),
            dict(v0=sol1.v, y0_knot=sol1.y_knot, y0_end=sol1.y_end,
                 settings=st, rho0=sol1.rho_bar), 2,
            ("fused_factor", "fused_admm_round")),
        "dense_batched_f64_post": (admm.solve_qp_batched, post64,
                                   dict(settings=ORACLE_SETTINGS), 2, ()),
        "dense_batched_f32_tension2": (
            admm.solve_qp_batched,
            build_tension2_qp(xg, yg, ang, kg, sg, n_seg, cfg),
            dict(settings=QPSettings()), 2, ()),
        "dense_scalar_f64": (admm.solve_qp, lane0(post64),
                             dict(settings=ORACLE_SETTINGS), 2, ()),
        "dense_scalar_f32": (admm.solve_qp, lane0(post32),
                             dict(settings=st), 2, ()),
        "dense_trace_f64": (admm.trace_rounds, lane0(post64), trace, 2,
                            ()),
        "path_scalar": (path_solver.solve_path_qp, (few,),
                        dict(settings=st, rho0=st.rho_bar_path), 1, ()),
        "path_trace": (path_solver.trace_path_rounds, (few,),
                       dict(trace, rho0=st.rho_bar_path), 1, ()),
    }


def solver_run(name, fn, args, kw, nodes, needs, device="cuda") -> dict:
    """One compiled standalone solver against its eager twin
    (``<name>_eager``) on the same inputs: the eager call, counted and
    timed; the first compiled call (warm-up, capture, replay) timed; then
    REPEATS replays, the first counted (rounds from the device's tally,
    launches by key), and one more under :class:`HostReads`. Every field
    of the first and the last replay bit for bit the eager call's, one
    graph with ``nodes`` conditional nodes, no host read in a call, the
    rounds and the launches by key the eager call's, ``needs`` launched."""
    eager = getattr(sys.modules[fn.__module__], fn.__name__ + "_eager")
    kernels.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    want = eager(*args, **kw)
    sync(device)
    eager_ms = 1e3 * (time.perf_counter() - t0)
    want_shape = dict(kernels.shape_launches)
    want_rounds = (want.rounds if dataclasses.is_dataclass(want)
                   else kw["n_rounds"])
    t0 = time.perf_counter()
    first = fn(*args, **kw)
    sync(device)
    first_s = time.perf_counter() - t0
    segs = last_solver_segments()
    replay = []
    for i in range(REPEATS):
        if i == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        got = fn(*args, **kw)
        sync(device)
        replay.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            rounds = segs.sync()["qp"]
            by_shape = dict(kernels.shape_launches)
            launches = dict(kernels.launches)
    _, reads = host_reads(lambda: fn(*args, **kw))
    graph = graph_report(segs)
    lead = torchutil.tree_leaves(args)[0]
    report = dict(
        phase="solvers", run=name, solver=fn.__name__,
        dtype=str(lead.dtype).replace("torch.", ""), shape=list(lead.shape),
        eager_ms=eager_ms,
        first_call_s=first_s, replay_ms_runs=replay,
        replay_ms=statistics.median(replay), **graph,
        expected_conditional_nodes=nodes, host_reads_per_call=reads,
        rounds=rounds, eager_rounds=want_rounds, launches=launches,
        shape_launches=by_shape,
        launches_equal_eager=by_shape == want_shape,
        unequal_first=bit_unequal(without_rounds(first),
                                  without_rounds(want)),
        unequal_replay=bit_unequal(without_rounds(got),
                                   without_rounds(want)),
        nvidia_smi=card_line())
    emit(report)
    bad = []
    if report["unequal_first"] or report["unequal_replay"]:
        bad.append(f"differs from eager in {report['unequal_first']} / "
                   f"{report['unequal_replay']}")
    if graph["capture"] and (graph["graphs"] != 1
                             or graph["conditional_nodes"] != nodes):
        bad.append(f"graph {graph}, {nodes} conditional nodes expected")
    if graph["capture"] and reads:
        bad.append(f"{reads} host reads inside the call")
    if rounds != want_rounds:
        bad.append(f"rounds {rounds} != eager {want_rounds}")
    if by_shape != want_shape:
        bad.append(f"launches {by_shape} != eager {want_shape}")
    idle = [k for k in needs if device == "cuda" and not launches.get(k)]
    if idle:
        bad.append(f"no {idle} on replay")
    if bad:
        raise AssertionError(f"solvers {name}: " + "; ".join(bad))
    return report


def drive_solvers(gm, scs, cfg, device="cuda") -> dict:
    """The seven compiled standalone solvers (``solver_cases``) each held
    to its eager twin (``solver_run``), the solver cache emptied after each
    so that its pool is freed."""
    if device == "cuda":
        kernels.require_conditional_nodes()
    torchutil.SOLVERS.clear()
    out = {}
    for name, case in solver_cases(gm, scs, cfg).items():
        out[name] = solver_run(name, *case, device=device)
        torchutil.SOLVERS.clear()
    return out


def check_golden(cfg, device="cuda"):
    """The card's results on the fixtures' 8 scenarios against the JAX
    package's stored results, at golden.TOLERANCES (TENSION's l at
    golden.FIXTURE_TOLERANCES; A*'s paths on the lanes of
    golden.PATH_LANES), flags exactly: solve_batch at the default, TENSION,
    A* and rough configs, the 3-cycle warm replanning stream and the long
    route at 512 knots. Then, as
    a reading that is not held, the TENSION fixture solved with the plain
    rounds on the card (QPSettings(fused_rounds=False)): a second witness
    of how far TENSION's l lands from the fixture without the kernels'
    summation order. The long fixture is solved on its own batch
    (golden.fixture_batch)."""
    gm, scs = golden.fixture_batch("default", device)
    failed = {}
    for name, kw in golden.CONFIGS.items():
        fcfg = dataclasses.replace(cfg, **kw)
        if name in golden.LONG_ROUTE:
            got = golden.arrays(pipeline.solve_batch(
                *golden.fixture_batch(name, device), fcfg, device=device))
            failures, diffs = golden.compare_fixture(
                name, got, golden.load(golden.FIXTURES[name]))
            emit(dict(phase="golden", fixture=name, batch=golden.BATCH,
                      diffs=diffs, failures=failures))
            if failures:
                failed[name] = failures
            continue
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


# --------------------------- the float64 oracle ------------------------------

# The reference optimum x* of every QP family: the dense solver in float64
# at eps 1e-6. On some lanes of the path QP its adaptive rho cycles between
# two values a round apart and never meets eps 1e-6, as the NumPy oracle's
# does there (17 of the 256 at a 3000-iteration cap in a CPU run,
# tests/measure_qp_bounds.py). Those lanes are solved again with rho fixed
# at 1 (ORACLE_FIXED), which converges on them. Fixed rho alone is no
# yardstick: on the other lanes it converges far more slowly than the
# adaptive rule.
ORACLE_SETTINGS = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
ORACLE_FIXED = dataclasses.replace(ORACLE_SETTINGS, adaptive_rho=False,
                                   rho_bar=1.0)
ORACLE_NUMPY_MAX_ITER = 4000  # the NumPy oracle's adaptive-rho attempt
ORACLE_PER_CLASS = 2     # lanes of each lane class the NumPy oracle solves
ORACLE_COST_RTOL = 1e-6  # the card's float64 cost against the NumPy oracle's
ORACLE_THREADS = 8
# Feasibility a kernel's solution is held to, abs + rel * ||A x*||_inf, and
# its cost gap, cost(x) - cost(x*) <= max(abs, rel |cost(x*)|). The JAX
# package's own bounds for the pass-2 QP (tests/test_parity_gridmap.py:
# 258-275) are feasibility 5e-3 and a gap of max(1e-4, 5e-3 |cost*|). Where
# the JAX package's own solutions exceed them, a family is held to what they
# meet: its post-smoothing and TENSION solutions exceed 5e-3 feasibility on
# the golden batch (6.3e-3, 7.7e-3), inside their termination band eps_abs +
# eps_rel ||A x||_inf, so those families add the band's relative term
# (tests/test_torch_smoothing_optimality.py); its pass 2 at 128 knots on this
# batch, on the CPU, reaches feasibility 5.41e-3 (at most 1.70e-3 beyond the
# band's relative term) and cost gaps up to 0.029 on lanes whose optimum
# costs below 0.1 (pass 2 stops after one round from pass 1's warm start),
# so pass 2 adds the band term and an absolute gap floor of 0.05 (the JAX
# solutions' worst ratio to it 0.59; tests/measure_qp_bounds.py prints these
# numbers, tests/test_torch_oracle_parity.py holds both packages to them).
# The long route's pass 2 at 512 knots ("path_long", drive_long_oracle) is
# held at pass 2's feasibility and a gap floor of 0.1: on the 8 lanes held
# there the JAX package's own pass-2 solutions reach a gap of 0.0671 on a
# lane whose optimum costs below 0.1 (1.34 times pass 2's 0.05, which it
# meets at 128 knots; the port's 0.0671 as well), so the floor doubles and
# their worst ratio to it is 0.67, as 0.05 was set at 0.59
# (tests/measure_qp_bounds.py --route long prints these numbers).
FEASIBILITY = {"tension2": (5e-3, 0.0), "post": (5e-3, 2e-3),
               "path": (5e-3, 2e-3), "tension": (5e-3, 2e-3),
               "path_long": (5e-3, 2e-3)}
GAP = {"tension2": (1e-4, 5e-3), "post": (1e-4, 5e-3),
       "path": (5e-2, 5e-3), "tension": (1e-4, 5e-3),
       "path_long": (1e-1, 5e-3)}
FAULT_DL = 0.1           # the fault: one lane's l moved this far at one knot


def qp_cost(P, q, x):
    """0.5 x^T P x + q^T x per lane (batch-leading)."""
    return (0.5 * (x[..., None, :] @ P @ x[..., :, None])[..., 0, 0]
            + (q * x).sum(-1))


def certify(family: str, dense, x, x_star) -> dict:
    """Per lane, x (B, nv) against the dense QPs (float64, batch-leading)
    and their optimum x_star: the worst bound violation and its bound
    (FEASIBILITY), and the cost gap and its bound."""
    P, q, A, l, u = dense
    x = x.to(P.dtype)
    Ax = (A @ x[..., None])[..., 0]
    a, r = FEASIBILITY[family]
    c_star = qp_cost(P, q, x_star)
    return dict(
        violation=torch.maximum(l - Ax, Ax - u).amax(-1),
        feas_bound=a + r * (A @ x_star[..., None])[..., 0].abs().amax(-1),
        gap=qp_cost(P, q, x) - c_star,
        gap_bound=torch.clamp(GAP[family][1] * c_star.abs(),
                              min=GAP[family][0]))


def certified(cert: dict, lanes) -> torch.Tensor:
    """Whether each of ``lanes`` (a bool mask) meets both bounds; True
    elsewhere."""
    ok = ((cert["violation"] <= cert["feas_bound"])
          & (cert["gap"] <= cert["gap_bound"]))
    return ok | ~lanes


def stages(gm, scs, cfg):
    """The main path's stages up to the path QP: (prep, corridor, geometry,
    pass-1 and pass-2 solutions)."""
    st = cfg.qp_settings()
    prep = pipeline.stage_prep(scs, cfg)
    smooth = pipeline.stage_smooth(gm, prep, cfg, st)
    xs2, ys2, cor = pipeline.stage_corridor(gm, scs, smooth, cfg)
    l_post, _ = pipeline.stage_post_smooth(cor, cfg, st)
    geo = pipeline.stage_geometry(gm, scs, xs2, ys2, cor, l_post, cfg)
    sol1, sol2 = pipeline.stage_path_qp(scs, geo, cfg, st)
    return prep, cor, geo, sol1, sol2


def qp_families(gm, scs, cfg) -> dict:
    """The QPs of the main path, rebuilt through the port's own stage
    functions and solved as the pipeline solves them (K3 for TENSION2 and
    post, K2 for the path QP's two passes), and the TENSION QP (K3 at
    (9, 9)) on the same prep stage: family -> (its dense form, the
    kernels' solution (B, nv), the solver's converged flags); the path
    QP's valid knots (B,); and the TENSION2 QPs from the dense builder."""
    st = cfg.qp_settings()
    prep, cor, geo, sol1, sol2 = stages(gm, scs, cfg)
    _, xg, yg, sg, ang, kg, n_seg = prep
    tcfg = dataclasses.replace(cfg, **VARIANTS["tension"])
    blocks = {
        "tension2": build_tension2_structured(xg, yg, ang, kg, sg, n_seg,
                                              cfg),
        "post": build_post_structured(cor.layers_s, cor.lower, cor.upper,
                                      cor.vehicle_l, cor.n_layers, cfg),
        "tension": build_tension_qp_blocks(gm, xg, yg, ang, n_seg, tcfg)}
    out = {}
    for name, qp in blocks.items():
        sol = structured.solve_structured_batched(qp, settings=st)
        out[name] = (structured.to_dense(qp), sol.v.flatten(1),
                     sol.converged)
    out["path"] = (assembly.to_dense(pipeline.build_path_qp(
        scs, geo, cfg, sol1=sol1)), sol2.v.flatten(1), sol2.converged)
    t2_dense = build_tension2_qp(xg, yg, ang, kg, sg, n_seg, cfg)
    return {k: out[k] for k in FEASIBILITY if k in out}, geo[5], t2_dense


def optimum(dense, solve=admm.solve_qp_batched):
    """x* of each QP of the dense float64 batch: the adaptive-rho solve at
    ORACLE_SETTINGS, and the lanes it leaves unconverged solved again at
    ORACLE_FIXED, both through ``solve`` (the compiled solver; its eager
    twin for :func:`oracle_compiled_vs_eager`). Returns (its QPSolution,
    the lanes solved again)."""
    opt = solve(*dense, settings=ORACLE_SETTINGS)
    redo = (~opt.converged).nonzero()[:, 0]
    if len(redo):
        fix = solve(*(a[redo] for a in dense), settings=ORACLE_FIXED)
        opt.x[redo] = fix.x
        opt.converged[redo] = fix.converged
        opt.iters[redo] += fix.iters
    return opt, redo.tolist()


ORACLE_EAGER_LANES = 8   # the first lanes held compiled against eager


def last_solver_segments():
    """The solver cache's entry used last (its Segments)."""
    return next(reversed(torchutil.SOLVERS.entries.values()))


def solver_graphs() -> list:
    """Every key of the solver cache: its solver, the leading size of its
    first input tensor, and its graph (:func:`graph_report`)."""
    return [dict(solver=key[0][0],
                 batch=torchutil.tree_leaves(segs.static_in)[0].shape[0],
                 **graph_report(segs))
            for key, segs in torchutil.SOLVERS.entries.items()]


def oracle_compiled_vs_eager(dense, refixed) -> dict:
    """The float64 optimum of a subset of the batch's lanes, compiled (the
    yardstick's own solver) against its eager twin: the first
    ORACLE_EAGER_LANES lanes and every lane the whole batch's solve had to
    fix at rho 1 (``refixed``), so the fixed re-solve runs in both. Every
    field bit for bit, the same lanes fixed. It holds the compiled dense
    solver on the oracle's own inputs without a second eager solve of the
    whole batch."""
    lanes = sorted(set(range(ORACLE_EAGER_LANES)) | set(refixed))
    sub = tuple(a[lanes] for a in dense)
    times, outs = {}, {}
    for mode, solve in (("eager", admm.solve_qp_batched_eager),
                        ("compiled", admm.solve_qp_batched)):
        sync(sub[0].device.type)
        t0 = time.perf_counter()
        outs[mode] = optimum(sub, solve)
        outs[mode][0].iters.sum().item()
        times[mode] = time.perf_counter() - t0
    (want, want_fix), (got, got_fix) = outs["eager"], outs["compiled"]
    unequal = bit_unequal(without_rounds(got), without_rounds(want))
    return dict(lanes=lanes, lanes_rho_fixed=got_fix, eager_seconds=times[
        "eager"], compiled_seconds=times["compiled"], unequal=unequal,
        held=not unequal and got_fix == want_fix)


def numpy_oracle(job):
    """The NumPy oracle on one lane (dense numpy arrays): first as the card
    solved that lane (adaptive rho, unless the card had to fix it), then
    with rho fixed if the adaptive attempt does not converge. Returns
    (OracleResult, seconds)."""
    dense, fixed = job
    t0 = time.perf_counter()
    for st in ([] if fixed else [dataclasses.replace(
            ORACLE_SETTINGS, max_iter=ORACLE_NUMPY_MAX_ITER)]) + [
            ORACLE_FIXED]:
        res = oracle.solve(*dense, eps_abs=st.eps_abs, eps_rel=st.eps_rel,
                           max_iter=st.max_iter, sigma=st.sigma,
                           alpha=st.alpha, rho_bar=st.rho_bar,
                           scaling_iters=st.scaling_iters,
                           adaptive_rho=st.adaptive_rho,
                           check_every=st.check_every)
        if res.status == "solved":
            break
    return res, time.perf_counter() - t0


def drive_oracle(gm, scs, cfg, device="cuda") -> dict:
    """Each QP family of the main path (and TENSION's) on the batch, in
    dense form on the device: its float64 optimum x* (optimum), held on
    ORACLE_PER_CLASS lanes of each lane class to the NumPy oracle (both
    solved, costs within ORACLE_COST_RTOL); the kernels' solutions held to
    x* on every lane their solver reports converged (certify); the float32
    dense solver on the dense builder's TENSION2 QPs (dense32_check); and
    the pass-2
    solution with one lane's l moved FAULT_DL at one knot, which must
    fail."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    B = len(scs.n_raw)
    per = B // len(scenarios.LANES)
    np_lanes = [c * per + i for c in range(len(scenarios.LANES))
                for i in range(ORACLE_PER_CLASS)]
    fams, n_valid, t2_dense = qp_families(gm, scs, cfg)
    reports, jobs, failed = {}, [], []
    for name, (dense32, x, conv) in fams.items():
        dense = tuple(a.double() for a in dense32)
        sync(device)
        t0 = time.perf_counter()
        opt, refixed = optimum(dense)
        opt.iters.sum().item()
        secs = time.perf_counter() - t0
        graphs = solver_graphs()
        cert = certify(name, dense, x, opt.x)
        ok = certified(cert, conv)
        conv_f = conv.double()
        reports[name] = dict(
            phase="oracle", family=name, lanes=B, nv=dense[0].shape[-1],
            nc=dense[2].shape[-2], lanes_checked=int(conv.sum()),
            f64_converged=int(opt.converged.sum()), f64_seconds=secs,
            f64_iters_max=int(opt.iters.max()),
            f64_iters_mean=float(opt.iters.double().mean()),
            f64_lanes_rho_fixed=refixed,
            worst_violation=float((cert["violation"] * conv_f).max()),
            feas_bound=list(FEASIBILITY[name]), gap_bound=list(GAP[name]),
            worst_violation_over_bound=float(
                (cert["violation"] / cert["feas_bound"] * conv_f).max()),
            worst_gap=float((cert["gap"] * conv_f).max()),
            worst_gap_over_bound=float(
                (cert["gap"] / cert["gap_bound"] * conv_f).max()),
            lanes_missed=(~ok).nonzero()[:, 0].tolist())
        if not bool(opt.converged.all()) or not bool(ok.all()):
            failed.append(name)
        c_star = qp_cost(*dense[:2], opt.x)
        jobs += [(name, b, float(c_star[b]), bool(opt.converged[b]),
                  (tuple(a[b].cpu().numpy() for a in dense), b in refixed))
                 for b in np_lanes]
        if name == "tension2":
            reports[name]["float32"] = dense32_check(t2_dense, conv, device)
            if not reports[name]["float32"]["held"]:
                failed.append("tension2 float32")
        if name == "path":
            reports[name]["fault"] = path_fault(dense, x, conv, opt.x,
                                                 n_valid)
            if not reports[name]["fault"]["caught"]:
                failed.append("path fault not caught")
            reports[name]["compiled_vs_eager"] = oracle_compiled_vs_eager(
                dense, refixed)
            if not reports[name]["compiled_vs_eager"]["held"]:
                failed.append("path compiled != eager")
        # The compiled keys' graphs and pools, freed before the next family.
        reports[name]["f64_keys"] = graphs
        torchutil.SOLVERS.clear()
        del dense, opt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ORACLE_THREADS) as ex:
        results = list(ex.map(numpy_oracle, [job[-1] for job in jobs]))
    np_secs = time.perf_counter() - t0
    for name in fams:
        rows = [(job, res, s) for job, (res, s) in zip(jobs, results)
                if job[0] == name]
        rel = [abs(float(qp_cost(*map(torch.as_tensor, job[-1][0][:2]),
                                 torch.as_tensor(res.x))) - job[2])
               / max(abs(job[2]), 1e-300) for job, res, _ in rows]
        solved = all(res.status == "solved" and job[3]
                     for job, res, _ in rows)
        reports[name]["numpy_oracle"] = dict(
            lanes=[job[1] for job, _, _ in rows], all_solved=solved,
            iters=[res.iters for _, res, _ in rows],
            max_rel_cost_diff=max(rel), seconds=[s for *_, s in rows])
        if not solved or max(rel) > ORACLE_COST_RTOL:
            failed.append(f"{name} numpy oracle")
    for rep in reports.values():
        emit(rep)
    out = dict(phase="oracle", numpy_oracle_seconds=np_secs,
               numpy_oracle_threads=ORACLE_THREADS, failed=failed)
    if device == "cuda":
        out.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                   nvidia_smi=card_line())
    emit(out)
    if failed:
        raise AssertionError(f"oracle: {failed}")
    return reports


LONG_ORACLE_PER_CLASS = 2   # long-route lanes of each lane class, 8 in all


def drive_long_oracle(gm, scs, cfg, device="cuda") -> dict:
    """The long route's pass-2 path QP (512 knots: 3072 variables, 3074
    rows) on LONG_ORACLE_PER_CLASS lanes of each lane class, rebuilt
    through the stage functions and solved as the pipeline solves it (K2
    in clusters): its float64 optimum on the card (optimum), which every
    lane must reach, and the K2 solution held to it at FEASIBILITY and GAP
    of "path_long" on every lane the solver reports converged; the
    solution with one lane's l moved FAULT_DL at one knot must fail."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    per = len(scs.n_raw) // len(scenarios.LANES)
    rows = torch.as_tensor([c * per + i for c in range(len(scenarios.LANES))
                            for i in range(LONG_ORACLE_PER_CLASS)],
                           device=scs.n_raw.device)
    sub = _rows(scs, rows)
    _, _, geo, sol1, sol2 = stages(gm, sub, cfg)
    dense = tuple(a.double() for a in assembly.to_dense(
        pipeline.build_path_qp(sub, geo, cfg, sol1=sol1)))
    sync(device)
    t0 = time.perf_counter()
    opt, refixed = optimum(dense)
    opt.iters.sum().item()
    secs = time.perf_counter() - t0
    graphs = solver_graphs()
    torchutil.SOLVERS.clear()
    conv = sol2.converged
    cert = certify("path_long", dense, sol2.v.flatten(1), opt.x)
    ok = certified(cert, conv)
    conv_f = conv.double()
    report = dict(
        phase="oracle", family="path_long", lanes=rows.tolist(),
        nv=dense[0].shape[-1], nc=dense[2].shape[-2],
        lanes_checked=int(conv.sum()), f64_converged=int(
            opt.converged.sum()), f64_seconds=secs,
        f64_iters_max=int(opt.iters.max()), f64_lanes_rho_fixed=refixed,
        f64_keys=graphs,
        worst_violation=float((cert["violation"] * conv_f).max()),
        worst_violation_over_bound=float(
            (cert["violation"] / cert["feas_bound"] * conv_f).max()),
        worst_gap=float((cert["gap"] * conv_f).max()),
        worst_gap_over_bound=float(
            (cert["gap"] / cert["gap_bound"] * conv_f).max()),
        feas_bound=list(FEASIBILITY["path_long"]),
        gap_bound=list(GAP["path_long"]), lanes_missed=rows[~ok].tolist(),
        fault=path_fault(dense, sol2.v.flatten(1), conv, opt.x, geo[5],
                         "path_long"))
    if device == "cuda":
        report.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                      nvidia_smi=card_line())
    emit(report)
    if not bool(opt.converged.all()) or not bool(ok.all()) or not bool(
            conv.any()) or not report["fault"]["caught"]:
        raise AssertionError(f"long-route oracle: {report}")
    return report


def dense32_check(dense32, conv, device) -> dict:
    """The float32 dense solver at default settings on the TENSION2 QPs of
    the dense builder (``build_tension2_qp``): its converged flags must
    equal the structured solver's (conv) and its cost gap meet the bound
    against their own float64 optimum on every lane. (The dense form of
    the block-banded QPs holds group 0's empty theta row, 0 = 0, which Ruiz
    scales by 1e8 an iteration: float32 overflows there, in both
    packages, tests/test_torch_dense_builders.py.)"""
    dense = tuple(a.double() for a in dense32)
    opt, _ = optimum(dense)
    sync(device)
    t0 = time.perf_counter()
    sol = admm.solve_qp_batched(*dense32, settings=QPSettings())
    sol.iters.sum().item()
    secs = time.perf_counter() - t0
    cert = certify("tension2", dense, sol.x, opt.x)
    flags_equal = bool(torch.equal(sol.converged, conv))
    gap_ok = bool((cert["gap"] <= cert["gap_bound"]).all())
    return dict(nv=dense[0].shape[-1], nc=dense[2].shape[-2], seconds=secs,
                iters_max=int(sol.iters.max()),
                converged=int(sol.converged.sum()), flags_equal=flags_equal,
                f64_converged=int(opt.converged.sum()),
                worst_gap_over_bound=float(
                    (cert["gap"] / cert["gap_bound"]).max()),
                worst_violation=float(cert["violation"].max()),
                held=flags_equal and gap_ok and bool(opt.converged.all()))


def path_fault(dense, x, conv, x_star, n_valid, family="path") -> dict:
    """The pass-2 solution with the first converged lane's l moved FAULT_DL
    at its middle valid knot: certify must refuse that lane."""
    b = int(conv.nonzero()[0, 0])
    k = int(n_valid[b]) // 2
    bad = x[b:b + 1].clone()
    bad[0, 6 * k] += FAULT_DL
    cert = certify(family, tuple(a[b:b + 1] for a in dense), bad,
                   x_star[b:b + 1])
    caught = not bool(certified(cert, torch.ones(1, dtype=torch.bool,
                                                 device=x.device)).all())
    return dict(lane=b, knot=k, dl=FAULT_DL, must_fail=True, caught=caught,
                violation=float(cert["violation"][0]),
                gap_over_bound=float(cert["gap"][0] / cert["gap_bound"][0]))


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


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
        want, want_rounds, want_shape = eager_record(gm, scs, cfg, device)
        # The first call captures the cached compiled solver's graph (or
        # finds it captured); the counted call replays it.
        first, _ = dist.solve_sharded(gm, scs, cfg, mesh)
        kernels.reset_launches()
        res, st = dist.solve_sharded(gm, scs, cfg, mesh)
        segs = last_segments()
        rounds = {f"{k}_rounds": v for k, v in segs.sync().items()}
        launches = dict(kernels.launches)
        by_shape = dict(kernels.shape_launches)
        _, reads = host_reads(lambda: dist.solve_sharded(gm, scs, cfg, mesh))
        graph = graph_report(segs)
        bits = bit_unequal(first, want) + bit_unequal(res, want)
        cache = dist._sharded_solver_cached.cache_info()._asdict()
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
    emit(dict(phase="compiled", run="dist", batch=B, unequal=bits,
              solver_cache=cache, **graph, host_reads_per_call=reads,
              rounds=rounds, eager_rounds=want_rounds, launches=launches,
              shape_launches=by_shape,
              launches_equal_eager=by_shape == want_shape))
    bad = graph_faults("dist", graph, reads, rounds, want_rounds, by_shape,
                       want_shape)
    if bad:
        raise AssertionError("; ".join(bad))
    if unequal or bits:
        raise AssertionError(f"dist: solve_sharded differs from solve_batch "
                             f"in {unequal}, bits of {bits}")
    if not cache["hits"]:
        raise AssertionError(f"dist: the sharded solver was not reused: "
                             f"{cache}")
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
    kernels.sync_counts()
    launches = dict(kernels.launches)
    text = buf.getvalue()
    lines = text.splitlines()
    need = ["solve: ok=True", f"batch {batch}: {batch}/{batch} ok",
            "[pipeline] total"] + [f"  {st}: " for st in PROFILED_STAGES]
    missing = [n for n in need if n not in text]
    at = [i for i, ln in enumerate(lines) if ln.startswith("[pipeline]")]
    names = [ln.split(":")[0].strip() for ln in
             lines[at[0] + 1:at[0] + 1 + len(PROFILED_STAGES)]] if at else []
    if names != list(PROFILED_STAGES) or len(at) != 1:
        missing.append(f"the JAX package's stage names in order: {names}")
    converged = any(ln.endswith("converged") for ln in lines)
    walk = drive_walkthrough()
    emit(dict(phase="cli", argv=argv, seconds=secs, launches=launches,
              missing=missing, converged_trace=converged,
              output=lines[:60], walkthrough=walk))
    if missing or not converged or "trace truncated" in text:
        raise AssertionError(f"cli: missing {missing}, converged trace "
                             f"{converged}")
    idle = [k for k, c in launches.items() if not c]
    if idle:
        raise AssertionError(f"cli: launched no {idle}")
    if walk["missing"]:
        raise AssertionError(f"walkthrough: missing {walk['missing']}")
    return launches


WALKTHROUGH = Path(__file__).resolve().parent / "examples" / \
    "quickstart_torch.py"


def drive_walkthrough() -> dict:
    """examples/quickstart_torch.py on its default device, the card: both
    of its solves must report every scenario ok."""
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [str(WALKTHROUGH), "--out", f"{tmp}/quickstart.png"]
        saved = sys.argv
        sys.argv = argv
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(WALKTHROUGH), run_name="__main__")
        finally:
            sys.argv = saved
        secs = time.perf_counter() - t0
    text = buf.getvalue()
    need = ["solved 8 scenarios: ok=8/8", "replanned (warm): ok=8/8"]
    return dict(seconds=secs, missing=[n for n in need if n not in text],
                output=text.splitlines())


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


SPLIT_REPS = 10     # calls of the idle split, each timed and span-timed


class GraphSpans:
    """Records a CUDA event pair around every ``CUDAGraph.replay`` made
    inside the block, on the stream it replays on: the device span of each
    graph, from the moment the stream reaches it to its last node, gaps
    between its kernels included."""

    def __enter__(self):
        self.pairs = []
        self._replay = replay = torch.cuda.CUDAGraph.replay

        def timed(graph):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay(graph)
            b.record()
            self.pairs.append((a, b))
        torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def spanned_call(solve, gm, scs, cfg) -> tuple:
    """One call of ``solve``: its wall time on the host clock (the device
    waited for), the summed device spans of its graph replays
    (:class:`GraphSpans`), both in ms, and the number of replays."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GraphSpans() as gs:
        solve(gm, scs, cfg, device="cuda")
    span = gs.ms()
    return 1e3 * (time.perf_counter() - t0), span, len(gs.pairs)


def graph_split(solve, gm, scs, cfg, reps: int = SPLIT_REPS) -> dict:
    """Where a replayed compiled call's wall time goes, without a
    profiler (whose tracing lengthens every gap): ``reps`` calls, each
    with its wall time and the device span of every graph replay in it
    (:func:`spanned_call`). Outside any graph = a call's wall time less
    its spans, taken call by call (the card's speed can change between
    calls): host reads, graph launches, input copies, result clones.
    Inside the graphs = the spans: the kernels and the gaps between them
    (split by :func:`profile_main_path`'s busy time)."""
    walls, spans, outside, launches = [], [], [], 0
    for _ in range(reps):
        wall, span, launches = spanned_call(solve, gm, scs, cfg)
        walls.append(wall)
        spans.append(span)
        outside.append(wall - span)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return dict(call_ms=statistics.median(walls), call_ms_runs=walls,
                graph_span_ms=statistics.median(spans),
                graph_span_ms_runs=spans, graph_launches=launches,
                outside_graph_ms=statistics.median(outside),
                outside_graph_ms_runs=outside, sm_clocks=clocks.strip())


SPAN_LEVEL = 0.02   # spans before and after a profiled call must agree


def profile_main_path(gm, scs, cfg, wall_unprofiled: float,
                      route: str = "adversarial", solve=None, extra=None):
    """One solve_batch (or ``solve``, e.g. the compiled solve_batch_jit,
    whose graph the caller has captured) under torch.profiler: device
    time by kernel and its sum, the device's busy time (one stream, so
    kernels do not overlap). The profiler's own host overhead lengthens
    the profiled run, so the busy share is given against the unprofiled
    wall time of the same solve as well. ``extra`` (e.g. a
    :func:`graph_split`) is added to the line. With ``solve``, one
    unprofiled call just before the profiled one and one just after give
    the graph span at the card's speed level of that call (the card runs
    at two, :data:`SPAN_LEVEL`): the gaps between kernels inside the
    graphs are their mean less the busy time, where the two agree and the
    trace holds every launch of the port's kernels (``trace_complete``:
    the profiler does not see every run of a conditional node's body);
    else ``None``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spans = []
    if solve is not None:
        spans.append(spanned_call(solve, gm, scs, cfg)[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (solve or pipeline.solve_batch)(gm, scs, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if solve is not None:
        spans.append(spanned_call(solve, gm, scs, cfg)[1])
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    # The port's kernels, one row per template instantiation, so launches
    # and device time split by shape (K1 by nb, K3 by (nb, r)).
    ours = [dict(name=k[:120], ms=t / 1e3, count=c)
            for k, t, c in rows if "pathopt" in k]
    report = dict(phase="profile", route=route, n_knots=cfg.n_knots,
                  wall_ms=wall * 1e3,
                  wall_unprofiled_ms=wall_unprofiled * 1e3,
                  device_busy_ms=busy_s * 1e3,
                  device_busy_share=busy_s / wall_unprofiled,
                  device_busy_share_profiled=busy_s / wall,
                  device_kernels=sum(r[2] for r in rows),
                  traced_port_launches=sum(r["count"] for r in ours),
                  top=[dict(name=k[:80], ms=t / 1e3, count=c)
                       for k, t, c in rows[:12]], port_kernels=ours,
                  **(extra or {}))
    if spans and "counted_port_launches" in report:
        complete = (report["traced_port_launches"]
                    == report["counted_port_launches"])
        span = statistics.mean(spans)
        level = abs(spans[0] - spans[1]) <= SPAN_LEVEL * span
        report.update(trace_complete=complete, span_around_ms=spans,
                      same_level=level, inside_graph_gap_ms=(
                          span - busy_s * 1e3) if complete and level
                      else None)
    emit(report)
    return report


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
    runtime, driver = kernels.graph_versions()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    emit(dict(phase="build", commands=kernels.build_info.get("commands"),
              seconds=time.perf_counter() - t0, library=str(so),
              ptxas=ptxas, torch_cuda=torch.version.cuda,
              cuda_runtime=runtime, cuda_driver=driver,
              nvcc_version=nvcc.strip().splitlines()[-2:]))

    cfg = PlannerConfig()
    t0 = time.perf_counter()
    gm, scs, _ = scenarios.build_adversarial(BATCH, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="map", batch=BATCH, esdf_shape=list(gm.esdf.shape),
              seconds=time.perf_counter() - t0))

    cfg_long = PlannerConfig(**scenarios.LONG_CONFIG)
    t0 = time.perf_counter()
    gm_long, scs_long, _ = scenarios.build_long_route(BATCH, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="map", route="long", batch=BATCH,
              map_shape=list(scenarios.LONG_SHAPE),
              esdf_shape=list(gm_long.esdf.shape),
              seconds=time.perf_counter() - t0))

    captured = capture_inputs(gm, scs, cfg)
    captured.update(capture_long(gm_long, scs_long, cfg_long, gm, scs))
    captured.update(wide_inputs(captured))
    primary, worst, by_shape = check_kernels(captured)
    check_cluster_path(captured)
    check_k4_clusters(captured)
    check_no_fallback(captured)
    geometry_rows = check_geometry(gm, scs, cfg)
    lattice_rows = check_lattice(gm, scs)
    prep_rows = check_prep(scs, cfg)

    eager = {}
    report, launches = drive_main_path(gm, scs, cfg, results=eager)
    drive_variants(gm, scs, cfg, results=eager)
    drive_replan(gm, scs, cfg)
    check_golden(cfg)
    long_report = drive_long_route(gm_long, scs_long, gm, scs,
                                   results=eager)
    comp = drive_compiled(gm, scs, cfg, gm_long, scs_long, eager)
    del eager
    drive_solvers(gm, scs, cfg)
    drive_oracle(gm, scs, cfg)
    drive_long_oracle(gm_long, scs_long, cfg_long)
    drive_dist(gm, scs, cfg)
    drive_cli()
    drive_pscan(gm, scs, cfg)
    if "--profile" in sys.argv[1:]:
        profile_main_path(gm, scs, cfg,
                          statistics.median(report["seconds_runs"]))
        profile_main_path(gm_long, scs_long, cfg_long, statistics.median(
            long_report["long"]["seconds_runs"]), route="long")
        # The compiled path on replay (each key captured first).
        for route, g, sc, c, run in (("adversarial", gm, scs, cfg, "main"),
                                     ("long", gm_long, scs_long, cfg_long,
                                      "long")):
            pipeline.solve_batch_jit(g, sc, c)
            kernels.reset_launches()
            pipeline.solve_batch_jit(g, sc, c)
            kernels.sync_counts()
            split = graph_split(pipeline.solve_batch_jit, g, sc, c)
            profile_main_path(g, sc, c, split["call_ms"] / 1e3,
                              route=route + "_compiled",
                              solve=pipeline.solve_batch_jit,
                              extra=dict(split, counted_port_launches=sum(
                                  kernels.launches.values())))

    rows = []
    for name, (source, replaces, _, _) in KERNELS.items():
        p = primary[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=worst[name], ms=p["ms"],
                         plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                         bound_by=p["bound_by"], library_ms=None,
                         by_shape=by_shape[name]))
    g = geometry_rows[f"B={BATCH}"]
    rows.append(dict(name="geometry", route="cuda", source=GEOMETRY_SOURCE,
                     replaces=GEOMETRY_REPLACES,
                     launches=launches["geometry"], max_abs_err=0.0,
                     ms=g["ms"], plain_ms=g["plain_ms"],
                     bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                     library_ms=None, by_shape=geometry_rows))
    g = lattice_rows[f"B={BATCH},K={cfg.dp_laterals}"]
    rows.append(dict(name="lattice", route="cuda", source=LATTICE_SOURCE,
                     replaces=LATTICE_REPLACES,
                     launches=launches["lattice"], max_abs_err=0.0,
                     ms=g["ms"], plain_ms=g["plain_ms"],
                     bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                     library_ms=None, by_shape=lattice_rows))
    g = prep_rows[f"B={BATCH}"]
    rows.append(dict(name="prep", route="cuda", source=PREP_SOURCE,
                     replaces=PREP_REPLACES, launches=launches["prep"],
                     max_abs_err=0.0, ms=g["ms"], plain_ms=g["plain_ms"],
                     bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                     library_ms=None, by_shape=prep_rows))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
