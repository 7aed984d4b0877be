"""Scenario-sharded execution over GPUs on ``torch.distributed`` (port of
``tpu_pathopt.dist``).

The reference is single-process (SURVEY.md §2.8). The port scales along the
scenario batch instead, one process per GPU: NCCL between processes on
``cuda``, gloo on the CPU. A :class:`Mesh` names the process group and this
rank's device, so the JAX package's signatures keep their ``mesh``
argument. There are no global arrays: every rank is handed the same global
batch, solves its own rows of it (:func:`shard_rows`) through
``pipeline.solve_batch`` (K1-K4 on its GPU), and returns the results of
those rows; the fleet statistics are ``all_reduce``d, so every rank holds
the same :class:`FleetStats`.

The JAX package's ``pallas_may_engage`` and its cache of jitted sharded
solvers have no counterpart: PyTorch runs eagerly, so there is nothing to
trace or compile per mesh, and the kernels run on every rank's GPU alike.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch
import torch.distributed as dist

from tpu_pathopt_torch import maps, pipeline
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.torchutil import resolve_device, to_device, tree_map


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device=None) -> int:
    """Join the process group of a multi-process run and return its size.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0's rendezvous. On ``device`` (``cuda`` unless the caller asks for the
    CPU) the group runs NCCL and this process takes the GPU
    ``local_device_ids[0]``, by default ``process_id`` modulo the GPUs
    present; on the CPU it runs gloo. A no-op that returns the current size
    when the group is already up, or 1 when single-process with no
    coordinator."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None and num_processes in (None, 1):
        return 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, "
                         "num_processes and process_id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = (local_device_ids[0] if local_device_ids
               else process_id % torch.cuda.device_count())
        torch.cuda.set_device(idx)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=url, world_size=num_processes,
                            rank=process_id)
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a batch: this process's ``rank`` of ``size``,
    its ``device``, and the process group of the collectives (None: a
    single process with no group, where a reduction is the local value)."""

    rank: int
    size: int
    device: torch.device
    group: object = None


def make_mesh(device=None) -> Mesh:
    """The mesh of every process of the current group (or of this process
    alone, with none), on ``device`` (``cuda``, this process's current GPU,
    unless the caller asks for another)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(rank=0, size=1, device=dev)
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=dev, group=dist.group.WORLD)


def fleet_reduce(t, mesh: Mesh, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over the mesh's ranks (``all_reduce``; the
    local value with no group), returned."""
    if mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def _barrier(mesh: Mesh):
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def _gather_rows(t, mesh: Mesh):
    """The rows of every rank's ``t`` (same shape on all), concatenated in
    rank order."""
    if mesh.group is None:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src.contiguous(), group=mesh.group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


@dataclasses.dataclass
class FleetStats:
    """Metrics reduced over the fleet (equal on every rank), padding
    excluded."""

    n_total: torch.Tensor
    n_ok: torch.Tensor
    n_blocked: torch.Tensor
    max_qp_iters: torch.Tensor
    mean_qp_iters: torch.Tensor


def pad_batch(scenarios: pipeline.Scenario, multiple: int):
    """Pad a scenario batch up to the next ``multiple`` by repeating its
    last scenario. Returns (padded scenarios, valid mask (Bp,), B)."""
    B = int(scenarios.n_raw.shape[0])
    Bp = -(-B // multiple) * multiple
    if Bp != B:
        scenarios = tree_map(lambda a: torch.cat(
            [a, a[-1:].expand((Bp - B,) + a.shape[1:])]), scenarios)
    valid = torch.arange(Bp, device=scenarios.n_raw.device) < B
    return scenarios, valid, B


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """The rows of an ``n_rows`` batch (a multiple of the mesh size) that
    this rank solves: the ``mesh.rank``-th of ``mesh.size`` equal blocks."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not divide over {mesh.size} "
                         "ranks")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _solve_rows(gm, scs, valid, config, settings, mesh, with_stats=True):
    """This rank's rows of the (padded) global batch, solved; with the
    fleet statistics when ``with_stats``."""
    dev = resolve_device(mesh.device)
    rows = shard_rows(int(valid.shape[0]), mesh)
    local = tree_map(lambda a: a[rows], to_device(scs, dev))
    res = pipeline.solve_batch(gm, local, config, settings,
                               device=mesh.device)
    if not with_stats:
        return res, None
    v = valid[rows].to(mesh.device)
    it = res.qp_iters.long() * v
    sums = fleet_reduce(torch.stack([v.sum(), (res.ok & v).sum(),
                                (res.blocked & v).sum(), it.sum()]), mesh)
    mx = fleet_reduce(it.max()[None], mesh, dist.ReduceOp.MAX)[0]
    stats = FleetStats(n_total=sums[0], n_ok=sums[1], n_blocked=sums[2],
                       max_qp_iters=mx,
                       mean_qp_iters=sums[3].float()
                       / torch.clamp(sums[0], min=1).float())
    return res, stats


def solve_sharded(gm: maps.GridMap, scenarios: pipeline.Scenario,
                  config: PlannerConfig, mesh: Mesh,
                  settings: QPSettings | None = None, valid=None):
    """Solve a global batch over the mesh: every rank is given the same
    ``scenarios`` and solves its block of rows (:func:`shard_rows`).

    A batch that does not divide by the mesh size is padded by repeating
    its last scenario and the padding is left out of the statistics; each
    rank then returns the results of its rows that are real scenarios, the
    global rows ``shard_rows(Bp, mesh)`` below B. With ``valid`` (a global
    (B,) mask, e.g. from ``make_global_batch(..., uneven=True)``) the batch
    is already padded: the rows where ``valid`` is False are left out of
    the statistics, and the rank returns all its rows. Returns
    (PathResult of this rank's rows, FleetStats, equal on every rank)."""
    if settings is None:
        settings = config.qp_settings()
    if valid is None:
        scenarios, valid, B = pad_batch(scenarios, mesh.size)
    else:
        B = None
    res, stats = _solve_rows(gm, scenarios, valid, config, settings, mesh)
    if B is not None:
        start = shard_rows(int(valid.shape[0]), mesh).start
        keep = max(0, min(int(res.ok.shape[0]), B - start))
        if keep != res.ok.shape[0]:
            res = tree_map(lambda a: a[:keep], res)
    return res, stats


def make_global_batch(gm: maps.GridMap, local_scenarios: pipeline.Scenario,
                      mesh: Mesh, uneven: bool = False):
    """The global batch from each process's local scenarios: every rank's
    rows in rank order, held by every rank and on its device, with the map
    moved there. Single-process it is the local batch.

    With ``uneven=True`` the local batch sizes may differ (a host with fewer
    scenarios must not stall the fleet): an ``all_gather`` of the (batch,
    devices) pairs gives the fleet's largest batch per device, every
    process pads its rows to it by repeating its last scenario, and the
    global ``valid`` mask marks the real ones. Returns (gm, scenarios) or,
    with ``uneven``, (gm, scenarios, valid): pass ``valid`` to
    :func:`solve_sharded`."""
    gm = to_device(gm, mesh.device)
    local = to_device(local_scenarios, mesh.device)
    B_local = int(local.n_raw.shape[0])
    pairs = _gather_rows(torch.tensor([[B_local, 1]], device=mesh.device),
                         mesh)
    if not uneven:
        if bool((pairs[:, 0] != B_local).any()):
            raise ValueError(f"local batches differ in size "
                             f"({pairs[:, 0].tolist()}): pass uneven=True")
        return gm, tree_map(lambda a: _gather_rows(a, mesh), local)
    per_dev = int((-(-pairs[:, 0] // pairs[:, 1].clamp(min=1))).max())
    padded, _, _ = pad_batch(local, per_dev)
    valid = torch.arange(per_dev, device=mesh.device) < B_local
    return (gm, tree_map(lambda a: _gather_rows(a, mesh), padded),
            _gather_rows(valid, mesh))


@dataclasses.dataclass
class StreamStats:
    """Totals over a streamed run (equal on every rank)."""

    n_total: torch.Tensor
    n_ok: torch.Tensor
    n_blocked: torch.Tensor
    max_qp_iters: torch.Tensor
    sum_qp_iters: torch.Tensor


def solve_streamed(gm: maps.GridMap, scenario_batches, config: PlannerConfig,
                   mesh: Mesh, settings: QPSettings | None = None,
                   consume=None):
    """Stream independent scenario batches through :func:`solve_sharded`.

    ``scenario_batches`` yields global batches, or ``(batch, valid)`` pairs
    of padded ones from ``make_global_batch(..., uneven=True)``. Batches
    are unrelated queries; for repeated solves of the same evolving queries
    use ``replan``, which carries each scenario's solver state. Each
    batch's result (this rank's rows) is handed to ``consume`` after the
    next batch was started, and the last one at the end. Returns
    (StreamStats, wall seconds, solves/s)."""
    if settings is None:
        settings = config.qp_settings()
    total = None
    prev = None
    t0 = time.perf_counter()
    for item in scenario_batches:
        scs, valid = item if isinstance(item, tuple) else (item, None)
        res, st = solve_sharded(gm, scs, config, mesh, settings, valid=valid)
        if prev is not None and consume is not None:
            consume(prev)
        prev = res
        s = StreamStats(n_total=st.n_total, n_ok=st.n_ok,
                        n_blocked=st.n_blocked, max_qp_iters=st.max_qp_iters,
                        sum_qp_iters=st.mean_qp_iters * st.n_total.float())
        total = s if total is None else StreamStats(
            n_total=total.n_total + s.n_total, n_ok=total.n_ok + s.n_ok,
            n_blocked=total.n_blocked + s.n_blocked,
            max_qp_iters=torch.maximum(total.max_qp_iters, s.max_qp_iters),
            sum_qp_iters=total.sum_qp_iters + s.sum_qp_iters)
    if prev is not None and consume is not None:
        consume(prev)
    n = int(total.n_total) if total is not None else 0
    dt = time.perf_counter() - t0
    return total, dt, (n / dt if dt > 0 else 0.0)


def measure_scaling(gm: maps.GridMap, make_batch, config: PlannerConfig,
                    settings: QPSettings | None = None,
                    mesh: Mesh | None = None,
                    per_shard: int = 8, reps: int = 10) -> dict:
    """Weak scaling of the sharded solve, one rank against the whole mesh,
    at a matched batch per rank: rank 0 alone solves ``per_shard``
    scenarios (the others wait), the mesh ``per_shard`` per rank. Every
    rep is timed between two barriers, so a mesh rep lasts until its
    slowest rank ends. Same keys as the JAX package's:

    - ``per_dev_solves_per_s_{1dev,full}`` and their ratio
      ``scaling_efficiency``;
    - ``collective_overhead_frac``: the full mesh with and without the
      fleet reductions, (t_with - t_without) / t_without;
    - ``machine_ratio_full_vs_1dev``: total over one rank's solves/s;
    - ``*_spread_frac``: half the range of the per-rep rates over their
      median. A derived ratio within the combined spread of its operands is
      noise (``collective_overhead_is_noise``).

    The result is equal on every rank (rank 0's one-rank numbers are
    broadcast)."""
    if settings is None:
        settings = config.qp_settings()
    mesh = make_mesh() if mesh is None else mesh

    def timed(m: Mesh, batch: int, with_stats=True):
        scs, valid, _ = pad_batch(make_batch(batch), m.size)

        def run():
            res, st = _solve_rows(gm, scs, valid, config, settings, m,
                                  with_stats)
            if m.device.type == "cuda":
                torch.cuda.synchronize(m.device)
            return res, st

        run()
        rates = []
        for _ in range(reps):
            _barrier(m)
            t0 = time.perf_counter()
            run()
            _barrier(m)
            rates.append(batch / (time.perf_counter() - t0))
        med = statistics.median(rates)
        return med, (max(rates) - min(rates)) / 2.0 / med

    one = torch.zeros(2, dtype=torch.float64, device=mesh.device)
    if mesh.rank == 0:
        alone = Mesh(rank=0, size=1, device=mesh.device)
        one[:] = torch.tensor(timed(alone, per_shard))
    if mesh.group is not None:
        dist.broadcast(one, src=0, group=mesh.group)
    sps_1, spr_1 = (float(x) for x in one)
    sps_n, spr_n = timed(mesh, per_shard * mesh.size)
    sps_ns, spr_ns = timed(mesh, per_shard * mesh.size, with_stats=False)
    per_dev_n = sps_n / mesh.size
    overhead = sps_ns / sps_n - 1.0 if sps_n > 0 else 0.0
    noise = spr_n + spr_ns
    return {"n_devices": mesh.size, "per_shard": per_shard, "reps": reps,
            "per_dev_solves_per_s_1dev": sps_1,
            "per_dev_solves_per_s_full": per_dev_n,
            "solves_per_s_1dev": sps_1, "solves_per_s_full": sps_n,
            "spread_frac_1dev": spr_1, "spread_frac_full": spr_n,
            "scaling_efficiency": per_dev_n / sps_1 if sps_1 > 0 else 0.0,
            "collective_overhead_frac": overhead,
            "collective_overhead_noise_frac": noise,
            "collective_overhead_is_noise": bool(abs(overhead) <= noise),
            "machine_ratio_full_vs_1dev": sps_n / sps_1 if sps_1 else 0.0}
