"""Warm-started replanning stream, the serving loop for evolving queries
(port of ``tpu_pathopt.replan``).

The reference demo re-solves the same query at 30 Hz as the vehicle moves
(src/test/demo.cpp:133-211: the timer callback re-runs
``PathOptimizer::solve`` with the updated pose against the same reference
points), and OSQP's persistent solver object warm-starts every re-solve
(base_solver.cpp:97-117). Here a whole batch of scenarios advances along its
solved paths and re-solves each cycle, with the path QP's state (v, y, rho)
carried between cycles in a :class:`pipeline.QPWarmStart`. Warm starting
changes only the ADMM start iterate: solutions still stop at the same OSQP
tolerances.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from tpu_pathopt_torch import maps, pipeline
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.torchutil import resolve_device, take, to_device, \
    tree_map

# jnp.interp's test for a zero-width interval: the float32 spacing of eps.
_DX0 = float(np.spacing(np.finfo(np.float32).eps))


def interp(x, xp, fp):
    """``jnp.interp`` row by row: x (B,), xp and fp (B, N) with each row of
    xp sorted -> (B,). As in JAX: the interval is found by a right-sided
    search, clamped to [1, N-1]; a zero-width interval gives its left
    value; a query left of xp[0] gives fp[0], right of xp[-1] gives
    fp[-1]."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x[:, None].contiguous(),
                           right=True).clamp(1, n - 1)[:, 0]
    x0, x1 = take(xp, i - 1), take(xp, i)
    f0, f1 = take(fp, i - 1), take(fp, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= _DX0
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def advance_scenarios(scs: pipeline.Scenario, res: pipeline.PathResult,
                      ds: float) -> pipeline.Scenario:
    """Advance each scenario's start pose ``ds`` meters along its solved
    path (the vehicle driving the plan for one cycle). The raw reference
    points (the route) are unchanged. Lanes that failed (``res.ok`` False)
    keep their pose and retry, as the reference demo logs the failure and
    replans next tick (demo.cpp:150-156)."""
    s, nv = res.s, res.n_valid
    s_end = take(s, torch.clamp(nv - 1, min=0))
    s_new = torch.minimum(torch.full_like(s_end, max(ds, 0.0)), s_end)
    # res.s is constant past n_valid (stage_finalize zeroes the padded
    # segments), and interp at a repeated abscissa takes the last match, a
    # padded knot. A strictly increasing padded tail makes a query at s_end
    # land on the last valid knot; queries below s_end are unaffected.
    i = torch.arange(s.shape[-1], device=s.device)
    sq = s + torch.where(i >= nv[:, None],
                         (i - nv[:, None] + 1).to(s.dtype) * 1e-3, 0.0)
    nx = interp(s_new, sq, res.x)
    ny = interp(s_new, sq, res.y)
    # The heading is interpolated on the circle (robust to +-pi wraps).
    nh = torch.atan2(interp(s_new, sq, torch.sin(res.heading)),
                     interp(s_new, sq, torch.cos(res.heading)))
    nk = interp(s_new, sq, res.k)
    ok = res.ok
    return dataclasses.replace(
        scs, start_x=torch.where(ok, nx, scs.start_x),
        start_y=torch.where(ok, ny, scs.start_y),
        start_heading=torch.where(ok, nh, scs.start_heading),
        start_k=torch.where(ok, nk, scs.start_k))


def replan_step(gm: maps.GridMap, scs: pipeline.Scenario,
                warm: pipeline.QPWarmStart, config: PlannerConfig,
                settings: QPSettings | None = None, advance_ds: float = 1.0,
                use_warm: bool = True, device=None):
    """One replanning cycle, compiled (the JAX package's jitted
    ``replan_step``, static in ``config``, ``settings``, ``advance_ds`` and
    ``use_warm``): solve (warm-started), carry the solver state, advance the
    batch along the solved paths, all in one compiled call
    (``pipeline.compiled_call``: one CUDA graph captured on the first call
    of a key and replayed after, no host read inside; the same program run
    on every call on the CPU).
    Returns ``(PathResult, QPWarmStart, Scenario)`` on ``device``, bit for
    bit :func:`replan_step_eager`'s. ``use_warm=False`` runs the same
    cycle cold (to measure what warm starting buys)."""
    return pipeline.compiled_call(
        gm, scs, config, settings, device,
        warm=warm if use_warm else None, return_warm=True,
        tail=lambda s, res: advance_scenarios(s, res, advance_ds),
        tail_key=("replan_step", advance_ds, use_warm))


def replan_step_eager(gm: maps.GridMap, scs: pipeline.Scenario,
                      warm: pipeline.QPWarmStart, config: PlannerConfig,
                      settings: QPSettings | None = None,
                      advance_ds: float = 1.0, use_warm: bool = True,
                      device=None):
    """:func:`replan_step` with every operation issued from the host."""
    dev = resolve_device(device)
    scs = to_device(scs, dev)
    res, warm_out = pipeline.solve_batch_warm(
        gm, scs, config, settings, warm=warm if use_warm else None,
        device=dev)
    return res, warm_out, advance_scenarios(scs, res, advance_ds)


@dataclasses.dataclass(frozen=True)
class ReplanStats:
    """Host-side summary of a replanning stream."""

    n_steps: int
    n_total: int                 # scenarios x steps
    n_ok: int
    seconds: float
    solves_per_s: float
    mean_iters: float            # ADMM iterations per solve, stream mean
    mean_iters_first: float      # cycle 0 (always cold)
    mean_iters_rest: float       # cycles 1.. (warm when enabled)


def _drive_stream(step, scs, warm, n_steps: int, consume,
                  n_scenarios: int | None = None) -> ReplanStats:
    """Run ``n_steps`` cycles back to back (each depends on the previous),
    hand each cycle's result to ``consume`` while the device works on the
    next, and wait for the device once, on the last cycle's statistics;
    moving the statistics to the host stays outside the timed window.

    ``step(scs, warm) -> (PathResult, warm, scs, (n_ok, sum_iters))`` with
    the statistics as 0-d device tensors, over ``n_scenarios`` scenarios
    (default: the batch's). A compiled cycle on the card reads nothing to
    the host, so the cycles are issued back to back and the device runs
    them without waiting on the host; the stream adds no read of its
    own."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    B = int(scs.n_raw.shape[0]) if n_scenarios is None else n_scenarios
    n_oks, sum_iters = [], []
    prev = None
    t0 = time.perf_counter()
    for _ in range(n_steps):
        res, warm, scs, (n_ok, s_it) = step(scs, warm)
        if prev is not None and consume is not None:
            consume(prev)
        prev = res
        n_oks.append(n_ok)
        sum_iters.append(s_it)
    if consume is not None:
        consume(prev)
    sum_iters[-1].item()
    dt = time.perf_counter() - t0
    it = torch.stack(sum_iters).cpu().double().numpy() / B
    n_ok_total = int(torch.stack(n_oks).sum())
    n_total = B * n_steps
    return ReplanStats(
        n_steps=n_steps, n_total=n_total, n_ok=n_ok_total, seconds=dt,
        solves_per_s=n_total / dt if dt > 0 else 0.0,
        mean_iters=float(it.mean()), mean_iters_first=float(it[0]),
        mean_iters_rest=float(it[1:].mean()) if n_steps > 1
        else float("nan"))


def replan_stream(gm: maps.GridMap, scs: pipeline.Scenario,
                  config: PlannerConfig, settings: QPSettings | None = None,
                  n_steps: int = 30, advance_ds: float = 1.0,
                  use_warm: bool = True, consume=None,
                  device=None) -> ReplanStats:
    """Run ``n_steps`` replanning cycles over a scenario batch on ``device``
    (``cuda`` unless the caller asks for another): the reference demo's
    30 Hz loop (demo.cpp:133-211) as a batch, each cycle the compiled
    :func:`replan_step`. See :func:`_drive_stream` for the dispatch and
    synchronisation."""
    dev = resolve_device(device)
    gm, scs = to_device(gm, dev), to_device(scs, dev)
    warm = pipeline.QPWarmStart.cold(int(scs.n_raw.shape[0]), config, dev)

    def step(scs_i, warm_i):
        res, warm_o, scs_o = replan_step(gm, scs_i, warm_i, config, settings,
                                         advance_ds, use_warm, dev)
        return res, warm_o, scs_o, (res.ok.sum(), res.qp_iters.sum())

    return _drive_stream(step, scs, warm, n_steps, consume)


def replan_stream_sharded(gm: maps.GridMap, scs: pipeline.Scenario,
                          config: PlannerConfig, mesh,
                          settings: QPSettings | None = None,
                          n_steps: int = 30, advance_ds: float = 1.0,
                          consume=None) -> ReplanStats:
    """:func:`replan_stream` over a ``dist.Mesh``: every rank is given the
    same global batch, and each owns its rows (``dist.shard_rows``) and
    their warm state across the cycles; the only traffic between ranks is
    the ``all_reduce`` of each cycle's fleet scalars (scenarios ok, ADMM
    iterations), so the statistics are the whole batch's, equal on every
    rank. ``consume`` gets this rank's rows. The batch must divide over the
    mesh: pad with ``dist.pad_batch`` first if it does not."""
    from tpu_pathopt_torch import dist

    B = int(scs.n_raw.shape[0])
    if B % mesh.size:
        raise ValueError(f"batch {B} must divide the mesh size {mesh.size}; "
                         "pad with dist.pad_batch")
    dev = resolve_device(mesh.device)
    gm = to_device(gm, dev)
    rows = dist.shard_rows(B, mesh)
    local = to_device(tree_map(lambda a: a[rows], scs), dev)
    warm = pipeline.QPWarmStart.cold(int(local.n_raw.shape[0]), config, dev)
    run = _sharded_replan_step(mesh, config, settings, advance_ds)
    return _drive_stream(lambda s, w: run(gm, s, w), local, warm, n_steps,
                         consume, n_scenarios=B)


@functools.lru_cache(maxsize=16)
def _sharded_replan_step(mesh, config: PlannerConfig,
                         settings: QPSettings | None, advance_ds: float):
    """The cached replanning cycle of one rank (the JAX package's jitted
    shard_map ``_sharded_replan_step``): the compiled :func:`replan_step`
    on this rank's rows and their warm state, then one ``all_reduce`` of
    the cycle's fleet scalars (scenarios ok, ADMM iterations), issued from
    the host after the graph. ``step(gm, scs, warm) -> (PathResult, warm,
    scs, (n_ok, sum_iters))``."""
    from tpu_pathopt_torch import dist

    def step(gm, scs_i, warm_i):
        res, warm_o, scs_o = replan_step(gm, scs_i, warm_i, config, settings,
                                         advance_ds, True, mesh.device)
        sums = dist.fleet_reduce(torch.stack([res.ok.sum(),
                                         res.qp_iters.long().sum()]), mesh)
        return res, warm_o, scs_o, (sums[0], sums[1])

    return step
