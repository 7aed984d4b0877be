#!/usr/bin/env python3
"""The port's tracing inside its compiled call, on one GPU, on the
benchmark's own cells (``h100_bench``): that with tracing off the timed
graph is the one a tree without tracing captures, that tracing on gives
the same results, what tracing costs, and what it reads.

    python3 tests/measure_call_trace.py [--parent DIR] [--seconds S]
        [--windows N] [--read S] [--out FILE]

For each cell of ``CELLS`` (``default.cold256``: ``solve_batch_jit`` at B
256; ``default.single``: ``solve_jit``), its driver and traffic as a
benchmark run builds them (seed ``SEED``, ``h100_bench/metrics/_incall``'s
``driver``), one process a tree:

- ``nodes``: the nodes of each graph captured, counted as its capture
  ends (the top level, and each conditional body as its own capture ends;
  ``pathopt_capture_nodes``, from this tree's kernel library): the
  untraced key here and in ``--parent`` (a tree without tracing, e.g. the
  parent commit unpacked under ``scratch_checkout/``), and the traced key
  here, with its own count by stage and body (``stage_nodes``,
  ``body_nodes``, ``stamp_nodes``);
- ``equal``: every input of the pool solved with tracing off and on, the
  results bit for bit equal;
- ``windows``: closed-loop windows of ``--seconds`` each, the driver's own
  calls, tracing off and on in turn (off, on, on, off, ...), each with its
  solves/s and median call ms;
- ``traced``: the benchmark's own reading of the cell's calls
  (``_incall.read_calls``: settled at the card's fast level, then whole
  turns of the pool for at least ``--read`` seconds); the set-up spans and
  counts of the process.

With no CUDA device it exits with code 2. One JSON line a cell and tree,
all of them in ``--out`` too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("default.cold256", "default.single")
SEED = 4200000017


def setup(cell: str, root: Path):
    """The cell's driver on the card, as ``h100_bench/run.py`` builds it,
    the program imported from ``root``."""
    sys.path[:0] = [str(root), str(ROOT)]
    import torch

    from h100_bench.metrics import _incall
    return _incall.driver(cell, SEED, torch.device("cuda", 0))


def node_counter(lib_path: str):
    """Count the nodes of each graph captured from now on, as its capture
    ends: ``{"top": [...], "bodies": [...]}``, in capture order."""
    import torch

    from tpu_pathopt_torch import kernels
    lib = ctypes.CDLL(lib_path)
    lib.pathopt_capture_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pathopt_capture_nodes.restype = ctypes.c_int

    def nodes(stream: int) -> int:
        n = ctypes.c_ulonglong()
        if lib.pathopt_capture_nodes(stream, ctypes.byref(n)):
            raise RuntimeError("pathopt_capture_nodes failed")
        return n.value

    got = {"top": [], "bodies": []}
    graph_end = torch.cuda.CUDAGraph.capture_end
    body_end = kernels.capture_end

    def top(self):
        got["top"].append(nodes(torch.cuda.current_stream().cuda_stream))
        return graph_end(self)

    def body(stream):
        got["bodies"].append(nodes(stream))
        return body_end(stream)

    torch.cuda.CUDAGraph.capture_end = top
    kernels.capture_end = body
    return got


def inputs_of(drv):
    from tpu_pathopt_torch import pipeline
    if hasattr(drv, "pool"):
        return drv.pool, pipeline.solve_batch_jit
    return drv.queries, pipeline.solve_jit


def run_cell(cell: str, root: Path, lib: str | None, seconds: float,
             windows: int, read: float) -> dict:
    import torch
    drv, ctx = setup(cell, root)
    from h100_bench.metrics import _incall
    from tpu_pathopt_torch import kernels, pipeline
    lib = lib or kernels.build_info.get("path") or str(kernels.build())
    counted = node_counter(lib)
    drv.warm()
    ctx.sync()
    out = dict(cell=cell, root=str(root), device=torch.cuda.get_device_name(0),
               off_nodes=dict(top=counted["top"][-1],
                              bodies=list(counted["bodies"])))
    out["off_nodes"]["total"] = (out["off_nodes"]["top"]
                                 + sum(out["off_nodes"]["bodies"]))
    if not hasattr(pipeline, "last_compiled"):
        return out
    from tpu_pathopt_torch import profiling
    from tpu_pathopt_torch.torchutil import tree_leaves
    nb = len(counted["bodies"])
    items, solve = inputs_of(drv)
    offs = [solve(ctx.gm, x, ctx.cfg, device=ctx.device) for x in items]
    with profiling.traced():
        ons = [solve(ctx.gm, x, ctx.cfg, device=ctx.device) for x in items]
    out["equal"] = all(
        all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(q)))
        for p, q in zip(offs, ons))
    _, _, segs = pipeline.last_compiled(traced=True)
    out["traced_nodes"] = dict(
        top=counted["top"][-1], bodies=counted["bodies"][nb:],
        stage_nodes=segs.stage_nodes, body_nodes=segs.body_nodes,
        loop_stage=segs.loop_stage, stamp_nodes=segs.stamp_nodes)
    rows, i = [], 0
    for on in (w % 4 in (1, 2) for w in range(windows)):
        with profiling.traced() if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            walls = _incall.closed_loop(drv, ctx.sync, seconds, i)
            secs = time.perf_counter() - t0
        i += len(walls)
        rows.append(dict(traced=on, calls=len(walls),
                         solves_per_s=len(walls) * drv.per_call / secs,
                         q50_ms=statistics.median(
                             (b - a) / 1e6 for a, b in walls)))
    out["windows"] = rows
    out["traced"] = _incall.read_calls(drv, ctx, seconds=read)
    out["setup"] = [[n, lb, (b - a) / 1e6] for n, lb, a, b in profiling.SETUP]
    out["counts"] = dict(profiling.COUNTS)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--read", type=float, default=4.0)
    p.add_argument("--out", type=Path)
    p.add_argument("--cell", help=argparse.SUPPRESS)
    p.add_argument("--root", type=Path, default=ROOT, help=argparse.SUPPRESS)
    p.add_argument("--lib", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.cell:       # one cell of one tree, in a process of its own
        print(json.dumps(run_cell(args.cell, args.root, args.lib,
                                  args.seconds, args.windows, args.read)),
              flush=True)
        return 0
    lines = []
    for cell in CELLS:
        here = sub(cell, ROOT, None, args)
        lines.append(here)
        if args.parent:
            lines.append(sub(cell, args.parent.resolve(), here.get("lib"),
                             args))
    if args.out:
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if all("error" not in x for x in lines) else 1


def sub(cell, root, lib, args) -> dict:
    cmd = [sys.executable, __file__, "--cell", cell, "--root", str(root),
           "--seconds", str(args.seconds), "--windows", str(args.windows),
           "--read", str(args.read)]
    if lib:
        cmd += ["--lib", lib]
    res = subprocess.run(cmd, capture_output=True, text=True)
    try:
        got = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        got = dict(cell=cell, root=str(root), error=res.stderr[-3000:])
    if "error" not in got and lib is None:
        got["lib"] = next(
            (str(p) for p in (root / "tpu_pathopt_torch" / "_build").glob(
                "libpathopt_kernels_*.so")), None)
    print(json.dumps(got), flush=True)
    return got


if __name__ == "__main__":
    sys.exit(main())
