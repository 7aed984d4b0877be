"""Wrappers of the QP kernels K1-K3, each beside its plain PyTorch version
(port of ``tpu_pathopt.solver.fused_rounds``).

- K1 :func:`fused_factor` (``csrc/fused_factor.cu``): block-tridiagonal
  Cholesky + explicit block inverse. Plain version: ``btridiag.factor`` +
  ``btridiag.inv_factors``.
- K2 :func:`fused_admm_round` (``csrc/fused_admm_round.cu``): ``iters``
  ADMM iterations of the lateral path QP plus its four residuals. Plain
  version: the plain path-QP step looped ``iters`` times.
- K3 :func:`fused_structured_round` (``csrc/fused_structured_round.cu``):
  ``iters`` ADMM iterations of a generic block-banded QP. Plain version: the
  plain structured step looped ``iters`` times.

The kernels' arrays are batch-last ("lane-major", e.g. (N, nb, nb, B)) so a
warp's 32 scenarios read neighbouring floats. A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches its kernel on the
current stream or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from tpu_pathopt_torch import kernels
from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.solver import assembly

F32 = torch.float32


def lane(a):
    """Batch-leading -> batch-last, contiguous."""
    return a.movedim(0, -1).contiguous()


def unlane(a):
    """Batch-last -> batch-leading."""
    return a.movedim(-1, 0)


# --------------------------------- K1 ---------------------------------------

def factor_plain(diag, offp):
    """K1's plain version, same layout: diag/offp (N, nb, nb, B), offp[0] = 0
    -> (Cinv, Wp) (N, nb, nb, B) with Wp[0] = 0."""
    C, W = btridiag.factor(unlane(diag), unlane(offp)[:, 1:])
    Cinv, W = btridiag.inv_factors(C, W)
    Wp = torch.cat([torch.zeros_like(W[:, :1]), W], dim=1)
    return lane(Cinv), lane(Wp)


def fused_factor(diag, offp):
    """Factor a batch of block-tridiagonal normal matrices (K1).
    diag/offp: (N, nb, nb, B) float32, offp[0] = 0; nb in {3, 4, 6}.
    Returns (Cinv, Wp) in the same layout."""
    dev = kernels.kernel_device(diag, offp)
    if dev is None:
        return factor_plain(diag, offp)
    n, nb, _, B = diag.shape
    for name, t in (("diag", diag), ("offp", offp)):
        kernels.expect(name, t, (n, nb, nb, B), F32, dev)
    if nb not in (3, 4, 6):
        raise ValueError(f"fused_factor: nb={nb}, the kernel takes 3, 4 or 6")
    cinv = torch.empty_like(diag)
    w = torch.empty_like(diag)
    err = kernels.lib().pathopt_fused_factor(
        kernels.ptr(diag), kernels.ptr(offp), kernels.ptr(cinv),
        kernels.ptr(w), n, nb, B, kernels.stream_ptr(dev))
    kernels.check(err, "fused_factor")
    kernels.launches["fused_factor"] += 1
    return cinv, w


# --------------------------------- K2 ---------------------------------------

def path_coll_coef(lf, lr, B, N, dtype, device):
    """The path QP's collision-row blocks for front/rear arms lf, lr."""
    coll = torch.tensor([[1.0, lf, 0.0, 0.0, 1.0, 0.0],
                         [1.0, lr, 0.0, 0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)
    return coll.expand(B, N, 2, 6)


def path_admm_step(ops, Ci, W, lb_knot, ub_knot, lb_end, ub_end, rk, re,
                   state, alpha, sigma):
    """One relaxed-ADMM iteration of the path QP, batch-leading. ``ops`` is
    (t_prev, coll_coef, end_idx); Ci (B, N, 6, 6), W (B, N-1, 6, 6)."""
    v, zk, ze, yk, ye = state
    rhs = sigma * v + assembly.at_mul_blocks(*ops, rk * zk - yk, re * ze - ye)
    vt = btridiag.solve_batched(Ci, W, rhs)
    ztk, zte = assembly.a_mul_blocks(*ops, vt)
    v_new = alpha * vt + (1 - alpha) * v
    ztmp_k = alpha * ztk + (1 - alpha) * zk + yk / rk
    ztmp_e = alpha * zte + (1 - alpha) * ze + ye / re
    zk_new = torch.minimum(torch.maximum(ztmp_k, lb_knot), ub_knot)
    ze_new = torch.minimum(torch.maximum(ztmp_e, lb_end), ub_end)
    return (v_new, zk_new, ze_new, rk * (ztmp_k - zk_new),
            re * (ztmp_e - ze_new))


def _amax(a):
    return torch.amax(torch.abs(a.reshape(a.shape[0], -1)), dim=-1)


def path_residuals(ops, p_diag, v, zk, ze, yk, ye):
    """(4, B): [pri, dua, max(|Av|, |z|), max(|Pv|, |A^T y|)] of a
    batch-leading path-QP iterate (OSQP unscaled residuals)."""
    Avk, Ave = assembly.a_mul_blocks(*ops, v)
    pv = p_diag * v
    Aty = assembly.at_mul_blocks(*ops, yk, ye)
    inf2 = lambda a, b: torch.maximum(_amax(a), _amax(b))  # noqa: E731
    return torch.stack([
        inf2(Avk - zk, Ave - ze),
        _amax(pv + Aty),
        torch.maximum(inf2(Avk, Ave), inf2(zk, ze)),
        torch.maximum(_amax(pv), _amax(Aty)),
    ])


def admm_round_plain(geom, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx,
                     pd, v, zk, ze, yk, ye, iters, alpha, sigma):
    """K2's plain version, same arguments and layout as
    :func:`fused_admm_round`."""
    N, _, _, B = Ci.shape
    ops = (unlane(tp), path_coll_coef(geom[0], geom[1], B, N, Ci.dtype,
                                      Ci.device), end_idx)
    Cb, Wb = unlane(Ci), unlane(Wp)[:, 1:]
    bnd = tuple(unlane(a) for a in (lbk, ubk, lbe, ube))
    rkb, reb = unlane(rk), unlane(re)
    state = tuple(unlane(a) for a in (v, zk, ze, yk, ye))
    for _ in range(iters):
        state = path_admm_step(ops, Cb, Wb, *bnd, rkb, reb, state, alpha,
                               sigma)
    res = path_residuals(ops, unlane(pd), *state)
    return tuple(lane(a) for a in state) + (res,)


def fused_admm_round(geom, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx,
                     pd, v, zk, ze, yk, ye, iters: int, alpha: float,
                     sigma: float):
    """``iters`` ADMM iterations of the path QP in one launch (K2).

    geom = (lf, lr), the collision rows' arms. Lane-major float32:
    Ci/Wp (N, 6, 6, B), tp (N, 3, 6, B), lbk/ubk/rk/pd/v/zk/yk (N, 6, B),
    lbe/ube/re/ze/ye (2, B); end_idx (B,) int32, clamped into [0, N). Returns
    (v, zk, ze, yk, ye, res) with res (4, B) = per-scenario [pri_res,
    dua_res, max(|Av|, |z|), max(|Pv|, |A^T y|)] of the final iterate."""
    dev = kernels.kernel_device(Ci)
    if dev is None:
        return admm_round_plain(geom, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re,
                                end_idx, pd, v, zk, ze, yk, ye, iters, alpha,
                                sigma)
    N, _, _, B = Ci.shape
    shapes = dict(Ci=(N, 6, 6, B), Wp=(N, 6, 6, B), tp=(N, 3, 6, B),
                  lbk=(N, 6, B), ubk=(N, 6, B), lbe=(2, B), ube=(2, B),
                  rk=(N, 6, B), re=(2, B), pd=(N, 6, B), v=(N, 6, B),
                  zk=(N, 6, B), ze=(2, B), yk=(N, 6, B), ye=(2, B))
    args = dict(Ci=Ci, Wp=Wp, tp=tp, lbk=lbk, ubk=ubk, lbe=lbe, ube=ube,
                rk=rk, re=re, pd=pd, v=v, zk=zk, ze=ze, yk=yk, ye=ye)
    for name, t in args.items():
        kernels.expect(name, t, shapes[name], F32, dev)
    kernels.expect("end_idx", end_idx, (B,), torch.int32, dev)
    # The kernel iterates in place on its outputs.
    v, zk, ze, yk, ye = (t.clone() for t in (v, zk, ze, yk, ye))
    res = torch.empty((4, B), dtype=F32, device=dev)
    sweep = torch.empty((N, 6, B), dtype=F32, device=dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_fused_admm_round(
        p(Ci), p(Wp), p(tp), p(lbk), p(ubk), p(lbe), p(ube), p(rk), p(re),
        p(end_idx), p(pd), p(v), p(zk), p(ze), p(yk), p(ye), p(res),
        p(sweep), N, B, int(iters), float(alpha), float(1 - alpha),
        float(sigma), float(geom[0]), float(geom[1]), kernels.stream_ptr(dev))
    kernels.check(err, "fused_admm_round")
    kernels.launches["fused_admm_round"] += 1
    return v, zk, ze, yk, ye, res


# --------------------------------- K3 ---------------------------------------

def structured_step(qp, Ci, W, rho, state, alpha, sigma):
    """One relaxed-ADMM iteration of block-banded QPs, batch-leading
    (``qp`` a ``structured.BlockBandedQP``; Ci (B, N, nb, nb), W (B, N-1, nb,
    nb))."""
    from tpu_pathopt_torch.qp import structured
    v, z, y = state
    rhs = sigma * v - qp.q + structured.at_mul(qp, rho * z - y)
    vt = btridiag.solve_batched(Ci, W, rhs)
    zt = structured.a_mul(qp, vt)
    v_new = alpha * vt + (1 - alpha) * v
    z_tmp = alpha * zt + (1 - alpha) * z + y / rho
    z_new = torch.minimum(torch.maximum(z_tmp, qp.lb), qp.ub)
    return v_new, z_new, rho * (z_tmp - z_new)


def structured_round_plain(Ci, Wp, ac, ap, q, lb, ub, rho, v, z, y, iters,
                           alpha, sigma):
    """K3's plain version, same arguments and layout as
    :func:`fused_structured_round`."""
    from tpu_pathopt_torch.qp import structured
    qp = structured.BlockBandedQP(
        p_diag=None, p_off=None, q=unlane(q), a_cur=unlane(ac),
        a_prev=unlane(ap), lb=unlane(lb), ub=unlane(ub))
    Cb, Wb = unlane(Ci), unlane(Wp)[:, 1:]
    rb = unlane(rho)
    state = (unlane(v), unlane(z), unlane(y))
    for _ in range(iters):
        state = structured_step(qp, Cb, Wb, rb, state, alpha, sigma)
    return tuple(lane(a) for a in state)


def fused_structured_round(Ci, Wp, ac, ap, q, lb, ub, rho, v, z, y,
                           iters: int, alpha: float, sigma: float):
    """``iters`` ADMM iterations of block-banded QPs in one launch (K3).
    Lane-major float32: Ci/Wp (N, nb, nb, B), ac/ap (N, r, nb, B),
    q/v (N, nb, B), lb/ub/rho/z/y (N, r, B); (nb, r) in {(4, 3), (3, 3)}.
    Returns (v, z, y)."""
    dev = kernels.kernel_device(Ci)
    if dev is None:
        return structured_round_plain(Ci, Wp, ac, ap, q, lb, ub, rho, v, z,
                                      y, iters, alpha, sigma)
    N, nb, _, B = Ci.shape
    r = ac.shape[1]
    if (nb, r) not in ((4, 3), (3, 3)):
        raise ValueError(f"fused_structured_round: (nb, r)=({nb}, {r}), the "
                         "kernel takes (4, 3) or (3, 3)")
    shapes = dict(Ci=(N, nb, nb, B), Wp=(N, nb, nb, B), ac=(N, r, nb, B),
                  ap=(N, r, nb, B), q=(N, nb, B), lb=(N, r, B), ub=(N, r, B),
                  rho=(N, r, B), v=(N, nb, B), z=(N, r, B), y=(N, r, B))
    args = dict(Ci=Ci, Wp=Wp, ac=ac, ap=ap, q=q, lb=lb, ub=ub, rho=rho, v=v,
                z=z, y=y)
    for name, t in args.items():
        kernels.expect(name, t, shapes[name], F32, dev)
    v, z, y = v.clone(), z.clone(), y.clone()
    sweep = torch.empty((N, nb, B), dtype=F32, device=dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_fused_structured_round(
        p(Ci), p(Wp), p(ac), p(ap), p(q), p(lb), p(ub), p(rho), p(v), p(z),
        p(y), p(sweep), N, nb, r, B, int(iters), float(alpha),
        float(1 - alpha), float(sigma), kernels.stream_ptr(dev))
    kernels.check(err, "fused_structured_round")
    kernels.launches["fused_structured_round"] += 1
    return v, z, y
