"""Wrappers of the QP kernels K1-K3, each beside its plain PyTorch version
(port of ``tpu_pathopt.solver.fused_rounds``).

- K1 :func:`fused_factor` (``csrc/fused_factor.cu``): block-tridiagonal
  Cholesky + explicit block inverse with the Pallas kernel's pivot floor.
  Plain version: :func:`factor_plain`, the Pallas kernel's unrolled
  Cholesky-Crout in its order (``btridiag.factor`` + ``inv_factors`` is
  the counterpart of the JAX ``btridiag``, used when ``fused_rounds`` is
  off, and makes a block that is not positive definite NaN).
- K2 :func:`fused_admm_round` (``csrc/fused_admm_round.cu``): ``iters``
  ADMM iterations of the lateral path QP plus its four residuals, with each
  knot's collision rows (:func:`collision_rows`; the Pallas kernel
  hard-codes one knot's). Plain version: the plain path-QP step looped
  ``iters`` times.
- K3 :func:`fused_structured_round` (``csrc/fused_structured_round.cu``):
  ``iters`` ADMM iterations of a generic block-banded QP. Plain version: the
  plain structured step looped ``iters`` times.

The kernels' arrays are batch-last ("lane-major", e.g. (N, nb, nb, B)). K1
gives each scenario a group of 16 lanes (nb 9), 8 (nb 6) or 4 (nb 3, 4),
one per block row, with 2, 4 or 8 neighbouring scenarios in one warp; K2
and K3 give each scenario one thread per knot and hold the whole round in
shared memory: one thread block while it holds the knots (256 of them; 150
at K3's (9, 9)), else a thread block cluster of up to 8 CTAs, each holding
a run of knots and streaming the sweep's blocks from a scratch buffer
(:func:`round_plan`, :func:`round_scratch`). So K2 takes up to 2048
knots, K3 2048 at (4, 3) and (3, 3) and 1968 at (9, 9). A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches its
kernel on the current stream or raises, also at a block shape its kernel
is not built for and past those limits. There is no fallback between the
two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pathopt_torch import kernels
from tpu_pathopt_torch.qp import btridiag
from tpu_pathopt_torch.solver import assembly
from tpu_pathopt_torch.torchutil import const, plain_read

F32 = torch.float32


def lane(a):
    """Batch-leading -> batch-last, contiguous."""
    return a.movedim(0, -1).contiguous()


def unlane(a):
    """Batch-last -> batch-leading."""
    return a.movedim(-1, 0)


# K2 and K3 run one thread per knot with the round in shared memory, one
# thread block or a cluster of them per scenario (csrc/btri_sweep.cuh); these
# are the limits of one block and of a cluster.
MAX_ROUND_THREADS = 256
MAX_SMEM_BYTES = 232448     # 227 KB, the most one block can have on the H100
MAX_CLUSTER = 8             # CTAs of one cluster that every Hopper part runs
CHUNK_KNOTS = 16            # knots' blocks a cluster CTA's ring loads at once
RING_CHUNKS = 2             # ... and the chunks its ring holds


def block_stride(nb: int) -> int:
    """Floats from one knot's G (or H) to the next in a cluster's scratch
    buffer and ring: nb^2 rounded up to whole 16-byte units."""
    return -(-nb * nb // 4) * 4


def round_smem_bytes(kernel: str, n: int, nb: int = 6, r: int = 3,
                     streamed: bool = False) -> int:
    """Bytes of shared memory one block of K2 (``"fused_admm_round"``, nb 6)
    or K3 (``"fused_structured_round"``) takes at ``n`` knots: per knot
    G_i and H_i (nb x nb each; not with ``streamed``), two vectors of nb
    and Cinv's lower triangle, then K2's transition blocks (3 x 6) and a
    6-float-per-warp reduction tail, or K3's a_cur and a_prev (r x nb
    each); with ``streamed`` (a CTA of a cluster, whose G and H stay in
    device memory) also a ring of RING_CHUNKS chunks of CHUNK_KNOTS blocks
    (:func:`block_stride` floats each) and a barrier (2 floats) a chunk.
    ``round_smem_bytes`` in ``csrc/btri_sweep.cuh`` computes the same, and
    the launchers refuse any other size."""
    per_knot = (0 if streamed else 2 * nb * nb) + 2 * nb + nb * (nb + 1) // 2
    ring = RING_CHUNKS * (CHUNK_KNOTS * block_stride(nb) + 2) if streamed \
        else 0
    if kernel == "fused_admm_round":
        return 4 * ((per_knot + 3 * nb) * n + 6 * (MAX_ROUND_THREADS // 32)
                    + ring)
    if kernel == "fused_structured_round":
        return 4 * ((per_knot + 2 * r * nb) * n + ring)
    raise KeyError(kernel)


class RoundPlan(NamedTuple):
    """A K2/K3 launch: ``cluster`` CTAs per scenario, ``knots`` per CTA
    (CTA j holds knots [j knots, (j + 1) knots)) and ``smem`` bytes of
    shared memory in each."""
    cluster: int
    knots: int
    smem: int


def round_limit(kernel: str, nb: int = 6, r: int = 3) -> int:
    """The most knots a K2/K3 launch takes at this block shape: a full
    cluster of CTAs, each with as many knots as its threads and streamed
    shared memory hold."""
    k = MAX_ROUND_THREADS
    while round_smem_bytes(kernel, k, nb, r, streamed=True) > MAX_SMEM_BYTES:
        k -= 1
    return MAX_CLUSTER * k


def round_plan(kernel: str, n: int, nb: int = 6, r: int = 3,
               cluster: int | None = None) -> RoundPlan:
    """The launch plan of K2/K3 at ``n`` knots: the smallest cluster size c
    (1 is one plain thread block) whose CTAs hold k = ceil(n / c) knots
    each in at most MAX_ROUND_THREADS threads and MAX_SMEM_BYTES of shared
    memory (the streamed layout when c > 1), none of them empty; or
    exactly c = ``cluster`` (a test of the cluster path at a shape one
    block holds). Past one block the smallest c is also the one that keeps
    the most scenarios resident: the registers bind, and the fewest threads
    idle in a ragged last warp. ``round_plan`` in ``csrc/btri_sweep.cuh``
    computes the same and the launchers refuse any other plan. ValueError
    where no plan exists: past :func:`round_limit` knots."""
    sizes = [cluster] if cluster else range(1, MAX_CLUSTER + 1)
    for c in sizes:
        k = -(-n // c)
        smem = round_smem_bytes(kernel, k, nb, r, streamed=c > 1)
        if (n >= 1 and 1 <= c <= MAX_CLUSTER and k <= MAX_ROUND_THREADS
                and smem <= MAX_SMEM_BYTES and (c - 1) * k < n):
            return RoundPlan(c, k, smem)
    raise ValueError(
        f"{kernel}: N={n}, nb={nb}, r={r}"
        + (f" in clusters of {cluster}" if cluster else "")
        + f" has no launch plan; the kernel takes 1 to "
        f"{round_limit(kernel, nb, r)} knots at this block shape (at most "
        f"{MAX_CLUSTER} CTAs of {MAX_ROUND_THREADS} knots and "
        f"{MAX_SMEM_BYTES} bytes of shared memory each)")


def round_scratch(plan: RoundPlan, n: int, nb: int, batch: int, device):
    """The device memory a K2/K3 launch on ``plan`` writes G and H to
    (2, B, n, :func:`block_stride`), or None for one CTA, which keeps them
    in shared memory."""
    if plan.cluster == 1:
        return None
    return torch.empty(2 * batch * n * block_stride(nb), dtype=F32,
                       device=device)


# --------------------------------- K1 ---------------------------------------

PIVOT_FLOOR = 1e-12
# The block sizes K1 is built for: the path QP (6), TENSION2 (4),
# post-smoothing (3) and TENSION (9).
FACTOR_NB = (3, 4, 6, 9)
_LOW29 = (1 << 29) - 1       # the float64 mantissa bits below float32's
_HALF29 = 1 << 28            # ... of a float32 midpoint
_INF64 = float("inf")


def fma(x, y, acc):
    """x * y + acc for float32 tensors, rounded once to float32, as a fused
    multiply-add rounds it (float32's normal range).

    The product of two float32 numbers is exact in float64, so s = acc + x y
    in float64 is the exact sum rounded once. Rounding s to float32 gives
    the exact sum's rounding, except where s fell on a float32 midpoint
    while the exact sum lies beside it: there s moves one float64 step
    toward the exact sum (round to odd), the rest of the sum coming from
    the error-free two-sum."""
    a = acc.double()
    p = x.double() * y.double()
    s = a + p
    tie = (s.view(torch.int64) & _LOW29) == _HALF29
    with plain_read():
        any_tie = bool(tie.any())
    if any_tie:
        pa = s - a
        e = (a - (s - pa)) + (p - pa)
        toward = torch.nextafter(s, torch.copysign(
            const(_INF64, dtype=s.dtype, device=s.device), e))
        s = torch.where(tie & (e != 0), toward, s)
    return s.float()


def fma_sum(terms):
    """sum_j x_j y_j over a list of (x_j, y_j) tensors, rounded as XLA's
    CPU backend rounds the Pallas kernel's `acc = x_0 y_0; acc = acc +
    x_j y_j ...`, contracting multiply-adds: the first two products as
    fma(x_0, y_0, x_1 y_1), then one :func:`fma` per further term."""
    (x0, y0), rest = terms[0], terms[1:]
    if not rest:
        return x0 * y0
    (x1, y1), rest = rest[0], rest[1:]
    acc = fma(x0, y0, x1 * y1)
    for x, y in rest:
        acc = fma(x, y, acc)
    return acc


def factor_plain(diag, offp):
    """K1's plain version, same layout: diag/offp (N, nb, nb, B), offp[0] = 0
    -> (Cinv, Wp) (N, nb, nb, B) with Wp[0] = 0.

    It computes what the Pallas kernel computes, knot by knot: W_i = Off_i
    Cinv_{i-1}^T, S_i = D_i - W_i W_i^T, an unrolled Cholesky-Crout with the
    pivot sqrt(max(d, 1e-12)) (NaN propagates, as ``jnp.maximum`` does), and
    the forward-substitution inverse. Every sum runs in the Pallas kernel's
    order with elementwise operations (:func:`fma_sum`), vectorised over the
    batch and over the rows or columns that do not depend on each other, so
    the two agree to rounding on any block, positive definite or not
    (``btridiag.factor`` instead turns a block that is not into NaN)."""
    n, nb, _, B = diag.shape
    floor = const(PIVOT_FLOOR, dtype=diag.dtype, device=diag.device)
    cinv = torch.empty_like(diag)
    wp = torch.empty_like(diag)
    ci_prev = torch.zeros_like(diag[0])
    for i in range(n):
        # W[a][b] = sum_j O[a][j] Cp[b][j]; S = D - W W^T
        O, D = offp[i], diag[i]
        W = fma_sum([(O[:, None, j], ci_prev[None, :, j]) for j in range(nb)])
        S = D - fma_sum([(W[:, None, j], W[None, :, j]) for j in range(nb)])
        wp[i] = W
        # Cholesky-Crout, column j: rows j..nb-1 at once; row j is the pivot.
        C = torch.zeros_like(D)
        for j in range(nb):
            e = S[j:, j]
            for k in range(j):
                e = fma(-C[j:, k], C[j, k], e)
            cjj = torch.sqrt(torch.maximum(e[0], floor))
            C[j, j] = cjj
            C[j + 1:, j] = e[1:] * (1.0 / cjj)
        # Forward-substitution inverse, row a with its columns j < a at once:
        # Ci[a][j] = -(sum_{k=j}^{a-1} C[a][k] Ci[k][j]) / C[a][a], the sum
        # for column j starting at k = j (fma_sum's order, column by column).
        Ci = torch.zeros_like(D)
        for a in range(nb):
            Ci[a, a] = 1.0 / C[a, a]
            if not a:
                continue
            dg = torch.diagonal(Ci, 0, 0, 1).movedim(-1, 0)[:a]
            acc = C[a, :a] * dg
            if a > 1:
                sub = torch.diagonal(Ci, -1, 0, 1).movedim(-1, 0)[:a - 1]
                acc[:a - 1] = fma(C[a, :a - 1], dg[:a - 1], C[a, 1:a] * sub)
            for k in range(2, a):
                acc[:k - 1] = fma(C[a, k], Ci[k, :k - 1], acc[:k - 1])
            Ci[a, :a] = -acc / C[a, a]
        cinv[i] = Ci
        ci_prev = Ci
    return cinv, wp


def fused_factor(diag, offp):
    """Factor a batch of block-tridiagonal normal matrices (K1).
    diag/offp: (N, nb, nb, B) float32, offp[0] = 0; on CUDA tensors nb is
    one of ``FACTOR_NB``. Returns (Cinv, Wp) in the same layout."""
    dev = kernels.kernel_device(diag, offp)
    if dev is None:
        return factor_plain(diag, offp)
    n, nb, _, B = diag.shape
    for name, t in (("diag", diag), ("offp", offp)):
        kernels.expect(name, t, (n, nb, nb, B), F32, dev)
    if nb not in FACTOR_NB:
        raise ValueError(f"fused_factor: nb={nb}, the kernel takes "
                         f"{FACTOR_NB}")
    cinv = torch.empty_like(diag)
    w = torch.empty_like(diag)
    err = kernels.lib().pathopt_fused_factor(
        kernels.ptr(diag), kernels.ptr(offp), kernels.ptr(cinv),
        kernels.ptr(w), n, nb, B, kernels.stream_ptr(dev))
    kernels.check(err, "fused_factor")
    kernels.count_launch("fused_factor", f"nb={nb}")
    return cinv, w


# --------------------------------- K2 ---------------------------------------

def collision_rows_device(coll_coef):
    """:func:`collision_rows` without its host read: the rows (N, 2, 2, B)
    and a 0-d bool device tensor, whether they have K2's structure, for
    the caller to check (``Segments.check``, :data:`ROWS_ERROR`). Only the
    shape is checked here (it is known on the host)."""
    if coll_coef.dim() != 4 or tuple(coll_coef.shape[2:]) != (2, 6):
        raise ValueError(f"coll_coef: shape {tuple(coll_coef.shape)}, "
                         "expected (B, N, 2, 6)")
    rows = coll_coef[..., :2]
    slack = torch.eye(2, dtype=coll_coef.dtype, device=coll_coef.device)
    ok = (coll_coef[..., 2:4] == 0).all() & (coll_coef[..., 4:6]
                                              == slack).all()
    return lane(rows.to(F32)), ok


ROWS_ERROR = ("coll_coef: K2 takes collision rows with zero kappa and u "
              "columns and the slack columns [[1, 0], [0, 1]]")


def collision_rows(coll_coef):
    """The collision rows' coefficients K2 takes, from a path QP's
    ``coll_coef`` (B, N, 2, 6): those of l and e_psi in each row, lane-major
    (N, 2, 2, B), one set per knot and scenario (they differ by knot under
    the rough far-away rows). K2's rows have no kappa or u term and one
    slack each, s_front in row 0 and s_rear in row 1, with coefficient 1;
    any other ``coll_coef`` raises ValueError, on any device, so no round
    iterates an operator other than the one factored. One host read. The
    path solver takes :func:`collision_rows_device` and checks its flag
    before the rounds."""
    rows, ok = collision_rows_device(coll_coef)
    if not ok.item():
        raise ValueError(ROWS_ERROR)
    return rows


def coll_coef_from_rows(cc):
    """The path QP's ``coll_coef`` (B, N, 2, 6) that :func:`collision_rows`
    reduced to ``cc`` (N, 2, 2, B)."""
    c = unlane(cc)
    B, N = c.shape[:2]
    slack = torch.eye(2, dtype=c.dtype, device=c.device).expand(B, N, 2, 2)
    return torch.cat([c, torch.zeros_like(c), slack], dim=-1)


def path_admm_step(ops, Ci, W, lb_knot, ub_knot, lb_end, ub_end, rk, re,
                   state, alpha, sigma, solve=None):
    """One relaxed-ADMM iteration of the path QP, batch-leading. ``ops`` is
    (t_prev, coll_coef, end_idx); Ci (B, N, 6, 6), W (B, N-1, 6, 6);
    ``solve`` the block-tridiagonal solve (``btridiag.solve_batched`` by
    default)."""
    v, zk, ze, yk, ye = state
    rhs = sigma * v + assembly.at_mul_blocks(*ops, rk * zk - yk, re * ze - ye)
    vt = (solve or btridiag.solve_batched)(Ci, W, rhs)
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


def admm_round_plain(cc, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx,
                     pd, v, zk, ze, yk, ye, iters, alpha, sigma):
    """K2's plain version, same arguments and layout as
    :func:`fused_admm_round`."""
    ops = (unlane(tp), coll_coef_from_rows(cc), end_idx)
    Cb, Wb = unlane(Ci), unlane(Wp)[:, 1:]
    bnd = tuple(unlane(a) for a in (lbk, ubk, lbe, ube))
    rkb, reb = unlane(rk), unlane(re)
    state = tuple(unlane(a) for a in (v, zk, ze, yk, ye))
    for _ in range(iters):
        state = path_admm_step(ops, Cb, Wb, *bnd, rkb, reb, state, alpha,
                               sigma)
    res = path_residuals(ops, unlane(pd), *state)
    return tuple(lane(a) for a in state) + (res,)


def fused_admm_round(cc, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re, end_idx,
                     pd, v, zk, ze, yk, ye, iters: int, alpha: float,
                     sigma: float, _cluster=None):
    """``iters`` ADMM iterations of the path QP in one launch (K2).

    cc (N, 2, 2, B): each knot's collision rows, the coefficients of l and
    e_psi in row 0 (+ s_front) and row 1 (+ s_rear), from
    :func:`collision_rows`. Lane-major float32:
    Ci/Wp (N, 6, 6, B), tp (N, 3, 6, B), lbk/ubk/rk/pd/v/zk/yk (N, 6, B),
    lbe/ube/re/ze/ye (2, B); end_idx (B,) int32, clamped into [0, N). Returns
    (v, zk, ze, yk, ye, res) with res (4, B) = per-scenario [pri_res,
    dua_res, max(|Av|, |z|), max(|Pv|, |A^T y|)] of the final iterate. On
    CUDA tensors N is at most 2048 (:func:`round_plan`); ``_cluster``
    forces the cluster size, for tests of the cluster path."""
    dev = kernels.kernel_device(Ci)
    if dev is None:
        return admm_round_plain(cc, Ci, Wp, tp, lbk, ubk, lbe, ube, rk, re,
                                end_idx, pd, v, zk, ze, yk, ye, iters, alpha,
                                sigma)
    N, _, _, B = Ci.shape
    shapes = dict(cc=(N, 2, 2, B), Ci=(N, 6, 6, B), Wp=(N, 6, 6, B),
                  tp=(N, 3, 6, B),
                  lbk=(N, 6, B), ubk=(N, 6, B), lbe=(2, B), ube=(2, B),
                  rk=(N, 6, B), re=(2, B), pd=(N, 6, B), v=(N, 6, B),
                  zk=(N, 6, B), ze=(2, B), yk=(N, 6, B), ye=(2, B))
    args = dict(cc=cc, Ci=Ci, Wp=Wp, tp=tp, lbk=lbk, ubk=ubk, lbe=lbe, ube=ube,
                rk=rk, re=re, pd=pd, v=v, zk=zk, ze=ze, yk=yk, ye=ye)
    for name, t in args.items():
        kernels.expect(name, t, shapes[name], F32, dev)
    kernels.expect("end_idx", end_idx, (B,), torch.int32, dev)
    plan = round_plan("fused_admm_round", N, cluster=_cluster)
    # The kernel reads the iterate, then writes its outputs over it.
    v, zk, ze, yk, ye = (t.clone() for t in (v, zk, ze, yk, ye))
    res = torch.empty((4, B), dtype=F32, device=dev)
    scratch = round_scratch(plan, N, 6, B, dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_fused_admm_round(
        p(cc), p(Ci), p(Wp), p(tp), p(lbk), p(ubk), p(lbe), p(ube), p(rk),
        p(re), p(end_idx), p(pd), p(v), p(zk), p(ze), p(yk), p(ye), p(res),
        kernels.ptr_or_null(scratch), N, B, int(iters), plan.cluster,
        plan.knots, _cluster or 0, plan.smem, float(alpha), float(1 - alpha),
        float(sigma), kernels.stream_ptr(dev))
    kernels.check(err, "fused_admm_round")
    kernels.count_launch("fused_admm_round",
                         f"nb=6,N={N},c={plan.cluster}")
    return v, zk, ze, yk, ye, res


# --------------------------------- K3 ---------------------------------------

# The (nb, r) K3 is built for: TENSION2 (4, 3), post-smoothing (3, 3) and
# TENSION (9, 9).
ROUND_SHAPES = ((4, 3), (3, 3), (9, 9))


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
                           iters: int, alpha: float, sigma: float,
                           _cluster=None):
    """``iters`` ADMM iterations of block-banded QPs in one launch (K3).
    Lane-major float32: Ci/Wp (N, nb, nb, B), ac/ap (N, r, nb, B),
    q/v (N, nb, B), lb/ub/rho/z/y (N, r, B). Returns (v, z, y). On CUDA
    tensors (nb, r) is one of ``ROUND_SHAPES`` and N is at most 2048 (1968
    at (9, 9); :func:`round_plan`); ``_cluster`` forces the cluster size,
    for tests of the cluster path."""
    dev = kernels.kernel_device(Ci)
    if dev is None:
        return structured_round_plain(Ci, Wp, ac, ap, q, lb, ub, rho, v, z,
                                      y, iters, alpha, sigma)
    N, nb, _, B = Ci.shape
    r = ac.shape[1]
    if (nb, r) not in ROUND_SHAPES:
        raise ValueError(f"fused_structured_round: (nb, r)=({nb}, {r}), the "
                         f"kernel takes {ROUND_SHAPES}")
    shapes = dict(Ci=(N, nb, nb, B), Wp=(N, nb, nb, B), ac=(N, r, nb, B),
                  ap=(N, r, nb, B), q=(N, nb, B), lb=(N, r, B), ub=(N, r, B),
                  rho=(N, r, B), v=(N, nb, B), z=(N, r, B), y=(N, r, B))
    args = dict(Ci=Ci, Wp=Wp, ac=ac, ap=ap, q=q, lb=lb, ub=ub, rho=rho, v=v,
                z=z, y=y)
    for name, t in args.items():
        kernels.expect(name, t, shapes[name], F32, dev)
    plan = round_plan("fused_structured_round", N, nb, r, cluster=_cluster)
    v, z, y = v.clone(), z.clone(), y.clone()
    scratch = round_scratch(plan, N, nb, B, dev)
    p = kernels.ptr
    err = kernels.lib().pathopt_fused_structured_round(
        p(Ci), p(Wp), p(ac), p(ap), p(q), p(lb), p(ub), p(rho), p(v), p(z),
        p(y), kernels.ptr_or_null(scratch), N, nb, r, B, int(iters),
        plan.cluster, plan.knots, _cluster or 0, plan.smem, float(alpha),
        float(1 - alpha), float(sigma), kernels.stream_ptr(dev))
    kernels.check(err, "fused_structured_round")
    kernels.count_launch("fused_structured_round",
                         f"nb={nb},r={r},N={N},c={plan.cluster}")
    return v, z, y
