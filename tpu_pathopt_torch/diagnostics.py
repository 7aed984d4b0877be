"""Failure diagnostics (port of ``tpu_pathopt.diagnostics``; reference:
``ReferencePathImpl::logBoundsInfo``,
src/data_struct/reference_path_impl.cpp:88-95, called on solver failure at
path_optimizer.cpp:144,155): dump the per-knot collision corridor of a
solve, so that a failed scenario can be inspected instead of being a bare
``ok=False``.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("tpu_pathopt_torch")


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def dump_bounds(result, index: int | None = None, max_rows: int = 200) -> str:
    """Format (and log at WARNING, as the reference's glog dump on failure)
    the collision corridor of one solve result: a ``pipeline.PathResult``,
    batched (pass ``index``) or of one scenario (``index=None``)."""
    pick = (lambda a: _np(a)) if index is None else (
        lambda a: _np(a)[index])
    cb = result.bounds
    front_lb, front_ub = pick(cb.front_lb), pick(cb.front_ub)
    rear_lb, rear_ub = pick(cb.rear_lb), pick(cb.rear_ub)
    s = pick(result.s)
    nv = int(pick(result.n_valid))
    header = (f"bounds dump: ok={bool(pick(result.ok))} "
              f"blocked={bool(pick(result.blocked))} n_valid={nv} "
              f"qp_iters={int(pick(result.qp_iters))} stages["
              f"input={bool(pick(result.ok_input))} "
              f"smooth={bool(pick(result.ok_smooth))} "
              f"corridor={bool(pick(result.ok_corridor))} "
              f"post={bool(pick(result.ok_post))} "
              f"init={bool(pick(result.ok_init))} "
              f"qp={bool(pick(result.ok_qp))}]")
    lines = [header,
             "  i        s   front[lb, ub]        rear[lb, ub]       width"]
    for i in range(min(nv, max_rows)):
        width = min(front_ub[i] - front_lb[i], rear_ub[i] - rear_lb[i])
        lines.append(
            f"{i:4d} {s[i]:8.2f}   [{front_lb[i]:7.3f},{front_ub[i]:7.3f}]"
            f"   [{rear_lb[i]:7.3f},{rear_ub[i]:7.3f}]   {width:7.3f}")
    if nv > max_rows:
        lines.append(f"  ... ({nv - max_rows} more knots)")
    msg = "\n".join(lines)
    logger.warning(msg)
    return msg
