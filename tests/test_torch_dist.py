"""The port's sharded fleet path (``tpu_pathopt_torch.dist`` and
``replan.replan_stream_sharded``) on the CPU.

Single process: the counterparts of ``tests/test_dist.py`` (sharded equals
local, a batch of 13, a stream of 3 batches, ``measure_scaling``'s keys),
and the ranks of a 4-rank mesh run one after another in this process, so
the row split is checked without processes. Two processes: a gloo group of
two OS processes on ``localhost``, in the pattern of
``tests/test_dist_multiprocess.py``, whose fleet statistics must agree
across the ranks and with one process, also with uneven local batches, and
whose sharded replanning stream must equal ``replan_stream``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_pathopt_torch import dist, maps, pipeline, replan
from tpu_pathopt_torch.config import PlannerConfig
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.torchutil import tree_map

ROOT = Path(__file__).resolve().parents[1]
TINY = PlannerConfig(n_knots=16, n_segment_points=16, dp_layers=8,
                     dp_laterals=9, bspline_samples=32, qp_max_iter=100)
ST = QPSettings(max_iter=100)
CHECK = ST.check_every


def inputs(offsets, device="cpu"):
    """tests/test_dist.py's corridor map and straight queries, one per
    start offset."""
    res, size = 0.4, 100
    mask = np.zeros((size, size), bool)
    yy = (0.5 * size - 0.5 - np.arange(size)) * res
    mask[:, np.abs(yy) >= 15.0] = True
    gm = maps.build_map(mask, resolution=res, device=device)
    B, R = len(offsets), 8
    raw_x = np.concatenate([np.linspace(-12, 12, 6), np.full(R - 6, 12.0)])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    full = lambda v: f(np.full(B, v))  # noqa: E731
    scs = pipeline.Scenario(
        raw_x=f(np.tile(raw_x, (B, 1))), raw_y=f(np.zeros((B, R))),
        n_raw=torch.full((B,), 6, dtype=torch.int64, device=device),
        start_x=full(-12.0), start_y=f(offsets), start_heading=full(0.0),
        start_k=full(0.0), target_x=full(12.0), target_y=full(0.0),
        target_heading=full(0.0))
    return gm, scs


def offsets(batch):
    return np.linspace(-0.5, 0.5, batch).astype(np.float32)


@pytest.fixture(scope="module")
def local16():
    gm, scs = inputs(offsets(16))
    return gm, scs, pipeline.solve_batch(gm, scs, TINY, ST, device="cpu")


def test_sharded_solve_matches_local(local16):
    gm, scs, res_local = local16
    mesh = dist.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    res, stats = dist.solve_sharded(gm, scs, TINY, mesh, ST)
    assert int(stats.n_total) == 16
    assert int(stats.n_ok) == int(res_local.ok.sum())
    assert int(stats.max_qp_iters) == int(res_local.qp_iters.max())
    np.testing.assert_array_equal(res.n_valid.numpy(),
                                  res_local.n_valid.numpy())
    np.testing.assert_allclose(res.l.numpy(), res_local.l.numpy(), atol=5e-3)


@pytest.mark.parametrize("batch", [16, 13])
def test_ranks_split_the_rows_and_their_stats_add_up(local16, batch):
    """The 4 ranks of a mesh, run one after another without a group: each
    solves its block of the batch padded to 16 (13 pads 3 copies of the
    last scenario) and returns its real rows; their rows in rank order are
    the local solve's, and their statistics sum to the batch's."""
    gm, scs, res_local = local16
    scs = tree_map(lambda a: a[:batch], scs)
    parts, n_total, n_ok = [], 0, 0
    for rank in range(4):
        mesh = dist.Mesh(rank=rank, size=4, device=torch.device("cpu"))
        res, stats = dist.solve_sharded(gm, scs, TINY, mesh, ST)
        assert res.ok.shape[0] == (4 if rank < 3 else batch - 12)
        parts.append(res)
        n_total += int(stats.n_total)
        n_ok += int(stats.n_ok)
    assert n_total == batch
    assert n_ok == int(res_local.ok[:batch].sum())
    l_cat = torch.cat([r.l for r in parts]).numpy()
    np.testing.assert_allclose(l_cat, res_local.l[:batch].numpy(), atol=5e-3)
    with pytest.raises(ValueError):
        dist.shard_rows(13, dist.Mesh(0, 4, torch.device("cpu")))


def test_pad_batch_repeats_the_last_scenario(local16):
    _, scs, _ = local16
    padded, valid, B = dist.pad_batch(tree_map(lambda a: a[:13], scs), 8)
    assert B == 13 and padded.n_raw.shape[0] == 16
    np.testing.assert_array_equal(valid.numpy(), np.arange(16) < 13)
    np.testing.assert_array_equal(padded.start_y[13:].numpy(),
                                  np.full(3, scs.start_y[12].item()))


def test_streamed_solve_accumulates_fleet_stats(local16):
    gm, scs, res_local = local16
    mesh = dist.make_mesh(device="cpu")
    consumed = []
    total, dt, sps = dist.solve_streamed(
        gm, (scs for _ in range(3)), TINY, mesh, ST,
        consume=lambda r: consumed.append(r.ok.numpy()))
    assert int(total.n_total) == 48 and len(consumed) == 3
    assert int(total.n_ok) == 3 * int(res_local.ok.sum())
    assert float(total.sum_qp_iters) == pytest.approx(
        3 * float(res_local.qp_iters.sum()))
    assert sps > 0


def test_make_global_batch_single_process_roundtrip(local16):
    gm, scs, res_local = local16
    mesh = dist.make_mesh(device="cpu")
    gm_g, scs_g = dist.make_global_batch(gm, scs, mesh)
    res, stats = dist.solve_sharded(gm_g, scs_g, TINY, mesh, ST)
    assert int(stats.n_total) == 16
    np.testing.assert_allclose(res.l.numpy(), res_local.l.numpy(), atol=5e-3)
    gm_u, scs_u, valid = dist.make_global_batch(
        gm, tree_map(lambda a: a[:5], scs), mesh, uneven=True)
    assert scs_u.n_raw.shape[0] == 5 and bool(valid.all())


def test_measure_scaling_reports_efficiency(local16):
    gm, scs, _ = local16
    sc = dist.measure_scaling(gm, lambda b: tree_map(lambda a: a[:b], scs),
                              TINY, ST, mesh=dist.make_mesh(device="cpu"),
                              per_shard=2, reps=1)
    assert sc["n_devices"] == 1
    assert sc["solves_per_s_1dev"] > 0 and sc["solves_per_s_full"] > 0
    assert sc["scaling_efficiency"] > 0
    assert sc["per_dev_solves_per_s_1dev"] == sc["solves_per_s_1dev"]
    assert sc["per_dev_solves_per_s_full"] == sc["solves_per_s_full"]
    assert sc["machine_ratio_full_vs_1dev"] > 0
    assert {"collective_overhead_frac", "collective_overhead_noise_frac",
            "collective_overhead_is_noise", "spread_frac_1dev",
            "spread_frac_full"} <= set(sc)


def test_replan_stream_sharded_one_rank_equals_replan_stream(local16):
    gm, scs, _ = local16
    scs = tree_map(lambda a: a[:8], scs)
    want = replan.replan_stream(gm, scs, TINY, ST, n_steps=2, device="cpu")
    got = replan.replan_stream_sharded(gm, scs, TINY,
                                       dist.make_mesh(device="cpu"), ST,
                                       n_steps=2)
    for f in ("n_steps", "n_total", "n_ok", "mean_iters",
              "mean_iters_first", "mean_iters_rest"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        replan.replan_stream_sharded(gm, scs, TINY,
                                     dist.Mesh(0, 3, torch.device("cpu")),
                                     ST, n_steps=1)


# ------------------------------ two processes --------------------------------

_WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[5])
from test_torch_dist import inputs, offsets, TINY, ST
from tpu_pathopt_torch import dist, replan
from tpu_pathopt_torch.torchutil import tree_map

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
n = dist.init_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                          process_id=pid, device="cpu")
assert n == nproc
mesh = dist.make_mesh(device="cpu")
res = dict(pid=pid, rank=mesh.rank, size=mesh.size)

def stats(s):
    return {k: float(getattr(s, k)) for k in ("n_total", "n_ok", "n_blocked",
                                             "max_qp_iters", "mean_qp_iters")}

# Even: each process holds its half of the 16 offsets.
lo = pid * 8
gm, scs_local = inputs(offsets(16)[lo:lo + 8])
gm_g, scs_g = dist.make_global_batch(gm, scs_local, mesh)
r, s = dist.solve_sharded(gm_g, scs_g, TINY, mesh, ST)
res.update(even=stats(s), global_start_y=scs_g.start_y.tolist(),
           l_local=r.l.tolist())

# Uneven: 5 scenarios here, 3 there; padded to 5 each, 8 real.
un = np.linspace(-0.4, 0.4, 8).astype(np.float32)
_, scs_un = inputs(un[:5] if pid == 0 else un[5:])
gm_u, scs_u, valid = dist.make_global_batch(gm, scs_un, mesh, uneven=True)
r2, s2 = dist.solve_sharded(gm_u, scs_u, TINY, mesh, ST, valid=valid)
total, _, _ = dist.solve_streamed(gm_u, ((scs_u, valid) for _ in range(2)),
                                  TINY, mesh, ST)
res.update(uneven=stats(s2), valid=valid.tolist(),
           uneven_rows=int(r2.ok.shape[0]),
           stream=dict(n_total=int(total.n_total), n_ok=int(total.n_ok)))

# The sharded replanning stream over the global 8 scenarios.
_, scs8 = inputs(offsets(8))
rs = replan.replan_stream_sharded(gm, scs8, TINY, mesh, ST, n_steps=2)
res.update(replan={k: getattr(rs, k) for k in (
    "n_total", "n_ok", "mean_iters", "mean_iters_first", "mean_iters_rest")})
with open(out + f"/worker{pid}.json", "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both workers' reports (two gloo ranks on localhost)."""
    tmp = tmp_path_factory.mktemp("gloo")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", str(port), str(tmp),
         str(ROOT / "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    return [json.loads((tmp / f"worker{pid}.json").read_text())
            for pid in range(2)]


def test_two_ranks_agree_with_each_other_and_one_process(two_ranks,
                                                         local16):
    gm, scs, res_local = local16
    w0, w1 = two_ranks
    assert (w0["rank"], w1["rank"], w0["size"]) == (0, 1, 2)
    np.testing.assert_array_equal(w0["global_start_y"], offsets(16))
    assert w0["even"] == w1["even"]
    assert w0["even"]["n_total"] == 16
    assert w0["even"]["n_ok"] == int(res_local.ok.sum())
    assert w0["even"]["max_qp_iters"] == int(res_local.qp_iters.max())
    assert abs(w0["even"]["mean_qp_iters"]
               - float(res_local.qp_iters.float().mean())) <= CHECK
    l_both = np.concatenate([w0["l_local"], w1["l_local"]])
    np.testing.assert_allclose(l_both, res_local.l.numpy(), atol=5e-3)


def test_two_ranks_uneven_batches(two_ranks):
    """5 and 3 local scenarios: each rank pads to 5, the valid mask marks
    the 8 real ones, and the statistics count only them, on both ranks and
    through the stream."""
    w0, w1 = two_ranks
    assert w0["valid"] == w1["valid"] == [True] * 5 + [True] * 3 + \
        [False] * 2
    assert w0["uneven_rows"] == w1["uneven_rows"] == 5
    assert w0["uneven"] == w1["uneven"]
    assert w0["uneven"]["n_total"] == 8
    gm, scs = inputs(np.linspace(-0.4, 0.4, 8).astype(np.float32))
    res = pipeline.solve_batch(gm, scs, TINY, ST, device="cpu")
    assert w0["uneven"]["n_ok"] == int(res.ok.sum())
    assert w0["stream"] == w1["stream"] == dict(n_total=16,
                                                 n_ok=2 * int(res.ok.sum()))


def test_two_ranks_replan_stream_sharded_equals_replan_stream(two_ranks,
                                                              local16):
    gm, _, _ = local16
    want = replan.replan_stream(gm, inputs(offsets(8))[1], TINY, ST,
                                n_steps=2, device="cpu")
    w0, w1 = two_ranks
    assert w0["replan"] == w1["replan"]
    got = w0["replan"]
    assert (got["n_total"], got["n_ok"]) == (want.n_total, want.n_ok)
    for f in ("mean_iters", "mean_iters_first", "mean_iters_rest"):
        assert abs(got[f] - getattr(want, f)) <= CHECK, f
