"""Structured ADMM solver for the lateral path QP, batched (port of
``tpu_pathopt.solver.path_solver``; reference: base_solver.cpp:56-117).

OSQP semantics: relaxed ADMM, per-row rho classes, per-element adaptive rho
with refactorization only where needed, unscaled-residual termination,
converged elements frozen, warm starts through ``v0``/``y0_*``/``rho0``.

:func:`solve_path_qp_batched`, the pipeline's solver: with
``settings.fused_rounds`` (the default) the factorization runs through
kernel K1 and every ``check_every``-iteration round through kernel K2, whose
arrays are batch-last; the residuals come back from the kernel. Otherwise the
plain PyTorch rounds run, their solve by parallel prefix where
``settings.pscan`` asks for it (it selects nothing for the kernels, as in the
JAX package). The rounds are batch-global (``Segments.loop``): setup,
round and refactor are separate functions over one in-place state, each
round computing its loop test and refactor gate on the device.

:func:`solve_path_qp` and :func:`trace_path_rounds` run the JAX package's
scalar rounds (uninverted factors, a refactor every round) on a batch; the
CLI's ``--verbose-qp`` prints the trace.

The three are compiled calls, as the JAX package jits them
(``torchutil.compiled``); ``<name>_eager`` runs the same program from the
host, one read a round.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.qp.admm import QPSettings
from tpu_pathopt_torch.solver import assembly, fused_rounds
from tpu_pathopt_torch.solver.assembly import PathQP
from tpu_pathopt_torch.solver.fused_rounds import lane, unlane
from tpu_pathopt_torch.torchutil import (EAGER, SOLVERS, compiled, scalar,
                                         scan_round)


@dataclasses.dataclass
class PathQPSolution:
    v: torch.Tensor          # (B, N, 6) per-knot [l, e_psi, kappa, u, s_f, s_r]
    y_knot: torch.Tensor     # (B, N, 6) duals in the z layout
    y_end: torch.Tensor      # (B, 2)
    iters: torch.Tensor      # (B,) int64
    converged: torch.Tensor  # (B,) bool
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    # Final per-element rho; pass 2 starts from pass 1's (OSQP keeps rho
    # across warm-started re-solves, base_solver.cpp:97-117).
    rho_bar: torch.Tensor    # (B,)
    # Batch-global rounds run: an int on the eager path, a 0-d device
    # tensor in a compiled call (``Segments.loop``).
    rounds: int | torch.Tensor = 0


def _rows(mask, a):
    """A (B,) mask shaped to select rows of the batch-leading ``a``."""
    return mask.reshape(mask.shape + (1,) * (a.dim() - 1))


@dataclasses.dataclass
class ScalarPathRun:
    """One batch of scalar-round solves in flight (JAX
    ``_scalar_round_setup``'s carry): the QP and what the rounds read of it
    (read only), and the loop state, which the rounds update in place.
    ``flags`` holds [any element active, any element refactored]; the
    rounds refactor themselves (a select, as the JAX round does), so the
    loop has no refactor of its own."""
    qp: PathQP
    ops: tuple               # (t_prev, coll_coef, end knot)
    bounds: tuple            # (lb_knot, ub_knot, lb_end, ub_end)
    cls: tuple               # (cls_knot, cls_end)
    state: tuple             # (v, zk, ze, yk, ye), batch-leading
    rk: torch.Tensor
    re: torch.Tensor
    C: torch.Tensor
    W: torch.Tensor
    rho_bar: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    flags: torch.Tensor


def _scalar_factor(qp: PathQP, cls, rho_bar, st: QPSettings):
    """The uninverted factors at ``rho_bar`` (each sweep step of the
    scalar round a triangular solve)."""
    cls_knot, cls_end = cls
    rk = rho_bar[:, None, None] * cls_knot
    re = rho_bar[:, None] * cls_end
    C, W = btridiag.factor(*assembly.normal_blocks(qp, rk, re, st.sigma))
    return rk, re, C, W


def _scalar_setup(qp: PathQP, v0, y0_knot, y0_end, settings: QPSettings,
                  rho0=None) -> ScalarPathRun:
    """The state before the first round of the scalar structured solver,
    shared by :func:`solve_path_qp` and :func:`trace_path_rounds` so the
    trace observes the rounds the solve runs (JAX
    ``_scalar_round_setup``). Unlike :func:`solve_path_qp_batched` the
    factors stay uninverted and every round refactors at the adapted rho,
    keeping it where no element needs it, as the JAX function does. Every
    state tensor is new (a given warm start is copied)."""
    st = settings
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    cls = assembly.rho_classes(qp)
    ops = (qp.t_prev, qp.coll_coef, assembly.end_knot(qp.end_idx, N))
    rho_bar0 = (torch.full((B,), st.rho_bar, dtype=dt, device=dev)
                if rho0 is None else
                scalar(rho0, dt, dev).expand(B).clone())
    v = torch.zeros((B, N, assembly.NB), dtype=dt, device=dev) \
        if v0 is None else v0.clone()
    yk = torch.zeros((B, N, 6), dtype=dt, device=dev) \
        if y0_knot is None else y0_knot.clone()
    ye = torch.zeros((B, 2), dtype=dt, device=dev) \
        if y0_end is None else y0_end.clone()
    zk, ze = assembly.a_mul_blocks(*ops, v)
    rk, re, C, W = _scalar_factor(qp, cls, rho_bar0, st)
    return ScalarPathRun(
        qp=qp, ops=ops, bounds=assembly.bounds(qp), cls=cls,
        state=(v, zk, ze, yk, ye), rk=rk, re=re, C=C, W=W, rho_bar=rho_bar0,
        it=torch.zeros((B,), dtype=torch.long, device=dev),
        conv=torch.zeros((B,), dtype=torch.bool, device=dev),
        pri=torch.full((B,), torch.inf, dtype=dt, device=dev),
        dua=torch.full((B,), torch.inf, dtype=dt, device=dev),
        flags=torch.ones((2,), dtype=torch.bool, device=dev))


def _scalar_round(run: ScalarPathRun, settings: QPSettings
                  ) -> ScalarPathRun:
    """One round of the scalar solver: ``check_every`` ADMM iterations,
    termination, and the adaptive-rho refactor, kept where rho changed."""
    st = settings
    conv = run.conv
    new = run.state
    for _ in range(st.check_every):
        new = fused_rounds.path_admm_step(
            run.ops, run.C, run.W, *run.bounds, run.rk, run.re, new,
            st.alpha, st.sigma, solve=btridiag.solve)
    state = tuple(torch.where(_rows(conv, a), a, n) for a, n in
                  zip(run.state, new))
    it = torch.where(conv, run.it, run.it + st.check_every)
    pri_res, dua_res, n_az, n_pd = fused_rounds.path_residuals(
        run.ops, run.qp.p_diag, *state)
    conv_new = conv | ((pri_res <= st.eps_abs + st.eps_rel * n_az)
                       & (dua_res <= st.eps_abs + st.eps_rel * n_pd))
    rk, re, C, W, rho_bar = run.rk, run.re, run.C, run.W, run.rho_bar
    need = torch.zeros_like(conv)
    if st.adaptive_rho:
        num = pri_res / torch.clamp(n_az, min=1e-12)
        den = dua_res / torch.clamp(n_pd, min=1e-12)
        ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
        need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
        rho_bar = torch.where(
            need, torch.clamp(rho_bar * ratio, 1e-6, 1e6), rho_bar)
        rk, re, C, W = (torch.where(_rows(need, a), n, a) for a, n in
                        zip((rk, re, C, W), _scalar_factor(
                            run.qp, run.cls, rho_bar, st)))
    flags = torch.stack([torch.any(~conv_new & (it < st.max_iter)),
                         torch.any(need)])
    return dataclasses.replace(
        run, state=state, rk=rk, re=re, C=C, W=W, rho_bar=rho_bar, it=it,
        conv=conv_new, pri=torch.where(conv, run.pri, pri_res),
        dua=torch.where(conv, run.dua, dua_res), flags=flags)


def _scalar_solution(run: ScalarPathRun, rounds) -> PathQPSolution:
    v, _, _, yk, ye = run.state
    return PathQPSolution(v=v, y_knot=yk, y_end=ye, iters=run.it,
                          converged=run.conv, pri_res=run.pri,
                          dua_res=run.dua, rho_bar=run.rho_bar,
                          rounds=rounds)


def _scalar_program(drv, qp: PathQP, v0, y0_knot, y0_end, rho0,
                    settings: QPSettings) -> PathQPSolution:
    run = drv("setup", lambda q, a, b, c, r: _scalar_setup(
        q, a, b, c, settings, rho0=r), qp, v0, y0_knot, y0_end, rho0)
    run, rounds = drv.loop("qp", run, functools.partial(
        _scalar_round, settings=settings), None, settings.max_iter > 0)
    return _scalar_solution(run, rounds)


def _static_rho0(rho0, qp: PathQP):
    """A number given as ``rho0`` as a 0-d tensor of the QP's dtype on its
    device, so that one compiled key serves every value (the same value
    the solver makes of the number)."""
    if isinstance(rho0, (bool, int, float)):
        return scalar(rho0, qp.p_diag.dtype, qp.p_diag.device)
    return rho0


def solve_path_qp_eager(qp: PathQP, v0=None, y0_knot=None, y0_end=None,
                        settings: QPSettings = QPSettings(),
                        rho0=None) -> PathQPSolution:
    """:func:`solve_path_qp` issued from the host, one read a round
    (``rounds`` a Python int)."""
    return _scalar_program(EAGER, qp, v0, y0_knot, y0_end, rho0, settings)


def solve_path_qp(qp: PathQP, v0=None, y0_knot=None, y0_end=None,
                  settings: QPSettings = QPSettings(),
                  rho0=None) -> PathQPSolution:
    """The scalar structured solver (JAX ``solve_path_qp``) on a batch of
    path QPs, on the device their tensors lie on: rounds until every
    element converged or reached ``max_iter``, converged elements frozen,
    so each element's result is the one it gets alone. It never reaches a
    kernel, in the JAX package either; the pipeline solves through
    :func:`solve_path_qp_batched`. A compiled call (on CUDA one graph per
    static key, the rounds a WHILE node), bit for bit
    :func:`solve_path_qp_eager`, ``rounds`` a 0-d device tensor."""
    return compiled(SOLVERS, ("solve_path_qp", settings), functools.partial(
        _scalar_program, settings=settings),
        (qp, v0, y0_knot, y0_end, _static_rho0(rho0, qp)),
        qp.p_diag.device)[0]


_TRACE_KEYS = ("iters", "pri_res", "dua_res", "rho_bar", "converged")


def _observed(run: ScalarPathRun) -> tuple:
    return run.it, run.pri, run.dua, run.rho_bar, run.conv


def _trace_program(drv, qp: PathQP, v0, y0_knot, y0_end, rho0,
                   settings: QPSettings, n_rounds: int) -> dict:
    """Exactly ``n_rounds`` rounds of the scalar solver (the JAX package's
    ``lax.scan``), each recorded into its row of buffers allocated before
    the first (:func:`torchutil.scan_round`)."""
    run = drv("setup", lambda q, a, b, c, r: _scalar_setup(
        q, a, b, c, settings, rho0=r), qp, v0, y0_knot, y0_end, rho0)
    tr = drv("trace.alloc", lambda run: {
        k: torch.empty((n_rounds,) + v.shape, dtype=v.dtype, device=v.device)
        for k, v in zip(_TRACE_KEYS, _observed(run))}, run)
    drv.loop("qp", run, scan_round(
        functools.partial(_scalar_round, settings=settings),
        [tr[k] for k in _TRACE_KEYS], _observed, n_rounds), None,
        n_rounds > 0)
    return tr


def trace_path_rounds_eager(qp: PathQP, settings: QPSettings = QPSettings(),
                            n_rounds: int = 16, v0=None, y0_knot=None,
                            y0_end=None, rho0=None) -> dict:
    """:func:`trace_path_rounds` issued from the host."""
    return _trace_program(EAGER, qp, v0, y0_knot, y0_end, rho0, settings,
                          n_rounds)


def trace_path_rounds(qp: PathQP, settings: QPSettings = QPSettings(),
                      n_rounds: int = 16, v0=None, y0_knot=None,
                      y0_end=None, rho0=None) -> dict:
    """Exactly ``n_rounds`` rounds of :func:`solve_path_qp`'s round body and
    the trajectory: a dict of iters, pri_res, dua_res, rho_bar and
    converged, each (n_rounds, B). Converged elements freeze, so the
    trajectory is what the solve ran. It is the reference's OSQP
    ``verbose = true`` (base_solver.cpp:59), the CLI's ``--verbose-qp``.
    A compiled call keyed by ``n_rounds`` too (on CUDA one graph, the
    rounds a WHILE node on a device counter), bit for bit
    :func:`trace_path_rounds_eager`."""
    return compiled(
        SOLVERS, ("trace_path_rounds", settings, n_rounds),
        functools.partial(_trace_program, settings=settings,
                          n_rounds=n_rounds),
        (qp, v0, y0_knot, y0_end, _static_rho0(rho0, qp)),
        qp.p_diag.device)[0]


@dataclasses.dataclass
class PathRun:
    """One batch of path-QP solves in flight: the QP and what the rounds
    read of it (bounds, row classes, the kernel-layout copies), and the loop
    state, which the rounds and refactors update in place. ``flags`` holds
    [any element active, any element needs a refactor, K2's collision rows
    have its structure] (the last from the setup, checked by
    :func:`solve_path`); the eager path reads them at the end of each
    round."""
    qp: PathQP
    bounds: tuple            # (lb_knot, ub_knot, lb_end, ub_end)
    cls: tuple               # (cls_knot, cls_end)
    end_idx: torch.Tensor
    lanes: tuple | None      # K2's batch-last operands
    rk: torch.Tensor
    re: torch.Tensor
    Ci: torch.Tensor
    W: torch.Tensor
    state: tuple             # (v, zk, ze, yk, ye)
    rho_bar: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    need: torch.Tensor
    flags: torch.Tensor


def _factor(run_qp, cls, rho_bar, st: QPSettings):
    cls_knot, cls_end = cls
    rk = rho_bar[:, None, None] * cls_knot
    re = rho_bar[:, None] * cls_end
    diag, off = assembly.normal_blocks(run_qp, rk, re, st.sigma)
    if st.fused_rounds:
        offp = torch.cat([torch.zeros_like(diag[:, :1]), off], 1)
        Ci, W = fused_rounds.fused_factor(lane(diag), lane(offp))
        return lane(rk), lane(re), Ci, W
    C, W = btridiag.factor(diag, off)
    Cinv, W = btridiag.inv_factors(C, W)
    return rk, re, Cinv, W


def path_setup(qp: PathQP, v0=None, y0_knot=None, y0_end=None,
               settings: QPSettings = QPSettings(), rho0=None) -> PathRun:
    """The factorization (K1 with ``settings.fused_rounds``) and the loop
    state before the first round, in K2's batch-last layout with
    ``fused_rounds``. Every state tensor is new (a given warm start is
    copied), so the rounds may write into it. With ``fused_rounds`` the
    collision rows' structure is checked on the device (``flags[2]``,
    which :func:`solve_path` holds)."""
    st = settings
    B, N = qp.p_diag.shape[:2]
    dt, dev = qp.p_diag.dtype, qp.p_diag.device
    bnds = assembly.bounds(qp)
    cls = assembly.rho_classes(qp)
    end_idx = assembly.end_knot(qp.end_idx, N)
    rho_bar = (torch.full((B,), st.rho_bar, dtype=dt, device=dev)
               if rho0 is None else
               scalar(rho0, dt, dev).expand(B).clone())
    rk, re, Ci, W = _factor(qp, cls, rho_bar, st)
    v = torch.zeros((B, N, assembly.NB), dtype=dt, device=dev) \
        if v0 is None else v0
    yk = torch.zeros((B, N, 6), dtype=dt, device=dev) \
        if y0_knot is None else y0_knot
    ye = torch.zeros((B, 2), dtype=dt, device=dev) \
        if y0_end is None else y0_end
    zk, ze = assembly.a_mul_blocks(qp.t_prev, qp.coll_coef, end_idx, v)
    state = (v, zk, ze, yk, ye)
    lanes = None
    rows_ok = torch.ones((), dtype=torch.bool, device=dev)
    if st.fused_rounds:
        # Kernel layout for the whole solve: batch last.
        cc_l, rows_ok = fused_rounds.collision_rows_device(qp.coll_coef)
        lanes = (cc_l, end_idx.to(torch.int32).contiguous(),
                 lane(qp.t_prev)) + tuple(lane(a) for a in bnds) \
            + (lane(qp.p_diag),)
        state = tuple(lane(a) for a in state)
    # The rounds write into the state: never into a caller's warm start.
    state = tuple(n.clone() if n.untyped_storage().data_ptr()
                  == a.untyped_storage().data_ptr() else n
                  for a, n in zip((v, zk, ze, yk, ye), state))
    return PathRun(
        qp=qp, bounds=bnds, cls=cls, end_idx=end_idx, lanes=lanes, rk=rk,
        re=re, Ci=Ci, W=W, state=state, rho_bar=rho_bar,
        it=torch.zeros((B,), dtype=torch.long, device=dev),
        conv=torch.zeros((B,), dtype=torch.bool, device=dev),
        pri=torch.full((B,), torch.inf, dtype=dt, device=dev),
        dua=torch.full((B,), torch.inf, dtype=dt, device=dev),
        need=torch.zeros((B,), dtype=torch.bool, device=dev),
        flags=torch.cat([torch.ones((2,), dtype=torch.bool, device=dev),
                         rows_ok.reshape(1)]))


def _sel(run: PathRun, mask, a):
    """A (B,) mask shaped to select elements of ``a`` in the run's layout."""
    B = mask.shape[0]
    if run.lanes is not None:
        return mask.reshape((1,) * (a.dim() - 1) + (B,))
    return mask.reshape((B,) + (1,) * (a.dim() - 1))


def path_round(run: PathRun, settings: QPSettings) -> PathRun:
    """One round: ``check_every`` ADMM iterations (K2, whose residuals come
    back from the kernel, or the plain steps), termination and the
    adaptive-rho update; the refactor it asks for is :func:`path_refactor`."""
    st = settings
    conv = run.conv
    if run.lanes is not None:
        cc_l, end_i32, tp_l, lbk_l, ubk_l, lbe_l, ube_l, pd_l = run.lanes
        *new, res = fused_rounds.fused_admm_round(
            cc_l, run.Ci, run.W, tp_l, lbk_l, ubk_l, lbe_l, ube_l, run.rk,
            run.re, end_i32, pd_l, *run.state, iters=st.check_every,
            alpha=st.alpha, sigma=st.sigma)
    else:
        ops = (run.qp.t_prev, run.qp.coll_coef, run.end_idx)
        solve = (btridiag.solve_batched_pscan if st.pscan
                 else btridiag.solve_batched)
        new = run.state
        for _ in range(st.check_every):
            new = fused_rounds.path_admm_step(
                ops, run.Ci, run.W, *run.bounds, run.rk, run.re, new,
                st.alpha, st.sigma, solve=solve)
        # Residuals of the unfrozen iterate, as the kernel returns them;
        # converged elements' values are discarded below.
        res = fused_rounds.path_residuals(ops, run.qp.p_diag, *new)
    state = tuple(torch.where(_sel(run, conv, a), a, n)
                  for a, n in zip(run.state, new))
    it = torch.where(conv, run.it, run.it + st.check_every)

    pri_res, dua_res, n_az, n_pd = res[0], res[1], res[2], res[3]
    eps_pri = st.eps_abs + st.eps_rel * n_az
    eps_dua = st.eps_abs + st.eps_rel * n_pd
    # Collision rows K2 does not take converge no element (a compiled call
    # raises on them only when its checks are read: Segments.check).
    conv_new = conv | ((pri_res <= eps_pri) & (dua_res <= eps_dua)
                       & run.flags[2])

    rho_bar, need = run.rho_bar, torch.zeros_like(conv)
    if st.adaptive_rho:
        num = pri_res / torch.clamp(n_az, min=1e-12)
        den = dua_res / torch.clamp(n_pd, min=1e-12)
        ratio = torch.sqrt(num / torch.clamp(den, min=1e-12))
        need = ~conv_new & ((ratio > 5.0) | (ratio < 0.2))
        rho_bar = torch.where(
            need, torch.clamp(rho_bar * ratio, 1e-6, 1e6), rho_bar)
    flags = torch.cat([torch.stack([
        torch.any(~conv_new & (it < st.max_iter)), torch.any(need)]),
        run.flags[2:]])
    return dataclasses.replace(
        run, state=state, it=it, conv=conv_new, rho_bar=rho_bar, need=need,
        pri=torch.where(conv, run.pri, pri_res),
        dua=torch.where(conv, run.dua, dua_res), flags=flags)


def path_refactor(run: PathRun, settings: QPSettings) -> PathRun:
    """Refactor at the adapted rho (K1) and keep the new factors on the
    elements that asked for them."""
    need = run.need
    rk_n, re_n, Ci_n, W_n = _factor(run.qp, run.cls, run.rho_bar, settings)
    return dataclasses.replace(
        run, rk=torch.where(_sel(run, need, run.rk), rk_n, run.rk),
        re=torch.where(_sel(run, need, run.re), re_n, run.re),
        Ci=torch.where(_sel(run, need, run.Ci), Ci_n, run.Ci),
        W=torch.where(_sel(run, need, run.W), W_n, run.W))


def path_solution(run: PathRun, rounds) -> PathQPSolution:
    state = run.state
    if run.lanes is not None:
        state = tuple(unlane(a) for a in state)
    v, _, _, yk, ye = state
    return PathQPSolution(v=v, y_knot=yk, y_end=ye, iters=run.it,
                          converged=run.conv, pri_res=run.pri,
                          dua_res=run.dua, rho_bar=run.rho_bar,
                          rounds=rounds)


def solve_path(drv, name: str, run: PathRun, settings: QPSettings) -> tuple:
    """The rounds of a set-up solve through the segment runner ``drv``;
    the collision rows' check (:meth:`Segments.check`) raises here on the
    eager path and is carried on the device in a compiled call."""
    drv.check(name + ".rows", run.flags[2], fused_rounds.ROWS_ERROR)
    return drv.loop(name, run, functools.partial(path_round,
                                                 settings=settings),
                    functools.partial(path_refactor, settings=settings),
                    settings.max_iter > 0)


def _batched_program(drv, qp: PathQP, v0, y0_knot, y0_end, rho0,
                     settings: QPSettings) -> PathQPSolution:
    run = drv("setup", lambda q, a, b, c, r: path_setup(
        q, a, b, c, settings, rho0=r), qp, v0, y0_knot, y0_end, rho0)
    run, rounds = solve_path(drv, "qp", run, settings)
    return drv("solution", path_solution, run, rounds)


def solve_path_qp_batched_eager(qp: PathQP, v0=None, y0_knot=None,
                                y0_end=None,
                                settings: QPSettings = QPSettings(),
                                rho0=None) -> PathQPSolution:
    """:func:`solve_path_qp_batched` issued from the host, one read a
    round (``rounds`` a Python int); collision rows K2 does not take raise
    before the first round."""
    return _batched_program(EAGER, qp, v0, y0_knot, y0_end, rho0, settings)


def solve_path_qp_batched(qp: PathQP, v0=None, y0_knot=None, y0_end=None,
                          settings: QPSettings = QPSettings(),
                          rho0=None) -> PathQPSolution:
    """Solve a batch of path QPs on the device their tensors lie on. A
    compiled call, as the JAX package jits it (on CUDA one graph per
    static key, the rounds a WHILE node, the refactor an IF node in it),
    bit for bit :func:`solve_path_qp_batched_eager`, ``rounds`` a 0-d
    device tensor; collision rows K2 does not take converge no element and
    raise at the first read of the counts after the call
    (``kernels.sync_counts``)."""
    return compiled(SOLVERS, ("solve_path_qp_batched", settings),
                    functools.partial(_batched_program, settings=settings),
                    (qp, v0, y0_knot, y0_end, _static_rho0(rho0, qp)),
                    qp.p_diag.device)[0]
