"""Batched block-tridiagonal Cholesky factorization and solve (port of
``tpu_pathopt.qp.btridiag``).

M = L L^T with L block-bidiagonal [C_i on the diagonal, W_{i-1} below]. The
knot recurrence is a Python loop over batched (B, nb, nb) blocks. These are
the plain versions behind the fused factor and round kernels of
``solver.fused_rounds``.
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


def matvec(diag, off, x):
    """M @ x for block-tridiagonal M. diag (B, m, nb, nb), off (B, m-1, nb,
    nb), x (B, m, nb)."""
    y = torch.einsum("bmij,bmj->bmi", diag, x)
    y[:, 1:] += torch.einsum("bmij,bmj->bmi", off, x[:, :-1])
    y[:, :-1] += torch.einsum("bmji,bmj->bmi", off, x[:, 1:])
    return y
