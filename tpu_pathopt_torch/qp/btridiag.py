"""Batched block-tridiagonal Cholesky factorization and solve (port of
``tpu_pathopt.qp.btridiag``).

M = L L^T with L block-bidiagonal [C_i on the diagonal, W_{i-1} below]. The
knot recurrence is a Python loop over batched (B, nb, nb) blocks. These are
the plain versions behind the fused factor and round kernels of
``solver.fused_rounds``; :func:`solve_batched_pscan` is the parallel-prefix
solve that ``QPSettings.pscan`` selects for the plain path-QP rounds.
"""

from __future__ import annotations

import torch


def factor(diag, off):
    """Block Cholesky of SPD block-tridiagonal matrices.

    diag: (B, m, nb, nb) diagonal blocks; off: (B, m-1, nb, nb) sub-diagonal
    blocks O_i = M[i+1, i]. Returns (C (B, m, nb, nb), W (B, m-1, nb, nb))
    with W_i = O_i C_i^{-T}. A block that is not positive definite yields
    NaNs, as ``jnp.linalg.cholesky`` does, instead of raising."""
    m = diag.shape[1]
    Cs, Ws = [], []
    C_prev = None
    for i in range(m):
        S = diag[:, i]
        if i > 0:
            # W^T = C_{i-1}^{-1} O_{i-1}^T
            W = torch.linalg.solve_triangular(
                C_prev, off[:, i - 1].transpose(-1, -2), upper=False
            ).transpose(-1, -2)
            Ws.append(W)
            S = S - W @ W.transpose(-1, -2)
        C, info = torch.linalg.cholesky_ex(S)
        C = torch.where((info == 0)[:, None, None], C, torch.nan)
        Cs.append(C)
        C_prev = C
    return torch.stack(Cs, 1), torch.stack(Ws, 1)


def solve(C, W, b):
    """M x = b given the factors of :func:`factor` (not inverted): each
    knot's step is a triangular solve. C (B, m, nb, nb), W (B, m-1, nb, nb),
    b (B, m, nb) -> (B, m, nb)."""
    m = C.shape[1]
    ys = []
    y = None
    for i in range(m):
        t = b[:, i] if i == 0 else b[:, i] - torch.einsum(
            "bij,bj->bi", W[:, i - 1], y)
        y = torch.linalg.solve_triangular(C[:, i], t[..., None],
                                          upper=False)[..., 0]
        ys.append(y)
    xs = [None] * m
    x = None
    for i in range(m - 1, -1, -1):
        t = ys[i] if i == m - 1 else ys[i] - torch.einsum(
            "bji,bj->bi", W[:, i], x)
        x = torch.linalg.solve_triangular(C[:, i].transpose(-1, -2),
                                          t[..., None], upper=True)[..., 0]
        xs[i] = x
    return torch.stack(xs, 1)


def inv_factors(C, W):
    """Explicit inverse of the lower-triangular Cholesky blocks, so the
    solve sweeps are matvec-only. Returns (Cinv, W)."""
    nb = C.shape[-1]
    eye = torch.eye(nb, dtype=C.dtype, device=C.device).expand(C.shape)
    return torch.linalg.solve_triangular(C, eye, upper=False), W


def solve_batched(Cinv, W, b):
    """M x = b given inverted factors. Cinv (B, m, nb, nb), W (B, m-1, nb,
    nb), b (B, m, nb) -> (B, m, nb)."""
    m = Cinv.shape[1]
    ys = []
    y = None
    for i in range(m):
        t = b[:, i] if i == 0 else b[:, i] - torch.einsum(
            "bij,bj->bi", W[:, i - 1], y)
        y = torch.einsum("bij,bj->bi", Cinv[:, i], t)
        ys.append(y)
    xs = [None] * m
    x = None
    for i in range(m - 1, -1, -1):
        t = ys[i] if i == m - 1 else ys[i] - torch.einsum(
            "bji,bj->bi", W[:, i], x)
        x = torch.einsum("bji,bj->bi", Cinv[:, i], t)
        xs[i] = x
    return torch.stack(xs, 1)


def _affine_scan(A, u, reverse: bool = False):
    """All prefixes of the affine recurrence x_i = A_i x_{i-1} + u_i,
    x_{-1} = 0 (with ``reverse``, x_i = A_i x_{i+1} + u_i, x_m = 0), along
    dim 1 of A (B, m, nb, nb) and u (B, m, nb): a log-depth (Hillis-Steele)
    scan whose level d composes each element with the one 2^d before it."""
    if reverse:
        A, u = A.flip(1), u.flip(1)
    m = A.shape[1]
    shift = 1
    while shift < m:
        # (A_r, u_r) after (A_l, u_l): (A_r A_l, A_r u_l + u_r)
        A_l, u_l = A[:, :-shift], u[:, :-shift]
        A_r, u_r = A[:, shift:], u[:, shift:]
        A = torch.cat([A[:, :shift], A_r @ A_l], 1)
        u = torch.cat([u[:, :shift], torch.einsum(
            "bmij,bmj->bmi", A_r, u_l) + u_r], 1)
        shift *= 2
    return u.flip(1) if reverse else u


def solve_batched_pscan(Cinv, W, b):
    """:func:`solve_batched` by parallel prefix over the knots: both sweeps
    as affine recurrences scanned in log2(m) levels of batched small
    products (``QPSettings.pscan``),

        y_i = Cinv_i b_i   - (Cinv_i W_i) y_{i-1}            (forward)
        x_i = Cinv_i^T y_i - (Cinv_i^T W_{i+1}^T) x_{i+1}    (backward).

    The same solve in another summation order. Cinv (B, m, nb, nb), W (B,
    m-1, nb, nb), b (B, m, nb) -> (B, m, nb)."""
    zero = torch.zeros_like(Cinv[:, :1])
    Wp = torch.cat([zero, W], 1)
    ys = _affine_scan(-Cinv @ Wp, torch.einsum("bmij,bmj->bmi", Cinv, b))
    Wn = torch.cat([W, zero], 1)
    Ct = Cinv.transpose(-1, -2)
    return _affine_scan(-Ct @ Wn.transpose(-1, -2),
                        torch.einsum("bmij,bmj->bmi", Ct, ys), reverse=True)


def matvec(diag, off, x):
    """M @ x for block-tridiagonal M. diag (B, m, nb, nb), off (B, m-1, nb,
    nb), x (B, m, nb)."""
    y = torch.einsum("bmij,bmj->bmi", diag, x)
    y[:, 1:] += torch.einsum("bmij,bmj->bmi", off, x[:, :-1])
    y[:, :-1] += torch.einsum("bmji,bmj->bmi", off, x[:, 1:])
    return y


def to_dense(diag, off):
    """The dense matrices (B, m nb, m nb) of a batch of block-tridiagonal
    ones (for tests and small problems)."""
    B, m, nb, _ = diag.shape
    M = diag.new_zeros((B, m * nb, m * nb))
    for i in range(m):
        M[:, i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] = diag[:, i]
    for i in range(m - 1):
        M[:, (i + 1) * nb:(i + 2) * nb, i * nb:(i + 1) * nb] = off[:, i]
        M[:, i * nb:(i + 1) * nb, (i + 1) * nb:(i + 2) * nb] = \
            off[:, i].transpose(-1, -2)
    return M
