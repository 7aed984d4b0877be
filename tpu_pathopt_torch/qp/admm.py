"""OSQP solver settings shared by every QP of the port.

Field-for-field copy of ``tpu_pathopt.qp.admm.QPSettings`` and ``INFTY``. The
dense ADMM solver of that module is not on the main path and is not ported
yet.
"""

from __future__ import annotations

import dataclasses

INFTY = 1e20


@dataclasses.dataclass(frozen=True)
class QPSettings:
    eps_abs: float = 2e-3
    eps_rel: float = 2e-3
    max_iter: int = 4000
    sigma: float = 1e-6
    alpha: float = 1.6
    rho_bar: float = 0.1
    # Initial rho for the lateral path QP; pass 2 also inherits pass 1's
    # final adapted rho (the reference's persistent OSQP solver object,
    # base_solver.cpp:97-117).
    rho_bar_path: float = 0.1
    scaling_iters: int = 10
    check_every: int = 25
    adaptive_rho: bool = True
    # Parallel-prefix block-bidiagonal solves: not ported yet (raises).
    pscan: bool = False
    # Run each check_every-iteration ADMM round, and every factorization,
    # through the CUDA kernels of ``solver.fused_rounds``. False runs the
    # plain PyTorch rounds instead.
    fused_rounds: bool = True
