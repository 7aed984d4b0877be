"""Bytes and float operations of the port's kernels, computed from their
shapes, and the card's data-sheet peaks: a frozen copy of the port's
``chip_smoke.work`` and ``bound_ms``. ``args`` may hold tensors or
:class:`Shape` stand-ins."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, at 700 W
FP32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


class Shape:
    """A tensor's shape, where only the shape is known."""

    def __init__(self, *shape):
        self.shape = tuple(shape)

    def numel(self) -> int:
        return math.prod(self.shape)


def _is_array(a) -> bool:
    return hasattr(a, "shape") and hasattr(a, "numel")


def _factor_flops(nb: int) -> int:
    """Float operations of one knot of K1 for one scenario."""
    w = nb * nb * (2 * nb - 1)
    s = nb * (nb + 1) // 2 * 2 * nb
    chol = sum(2 * j + 2 + (nb - 1 - j) * (2 * j + 1) for j in range(nb))
    inv = sum(1 + sum(2 * (r - j) + 1 for r in range(j + 1, nb))
              for j in range(nb))
    return w + s + chol + inv


def _sweep_flops(nb: int) -> int:
    """One knot of one forward or backward sweep: the W matvec, the
    subtraction and the triangular Cinv matvec."""
    return nb * (2 * nb - 1) + nb + nb * nb


def work(name: str, args) -> tuple[int, int]:
    """(bytes, float operations) the kernel's function needs on ``args``:
    each input read once, each output written once."""
    f = 4
    if name == "fused_factor":
        n, nb, _, b = args[0].shape
        ins = n * nb * (nb + 1) // 2 + (n - 1) * nb * nb
        return (ins + 2 * n * nb * nb) * b * f, n * b * _factor_flops(nb)
    if name == "fused_admm_round":
        # the collision rows (4 floats a knot), the factors and the rest
        ci, iters = args[1], args[17]
        n, nb, _, b = ci.shape
        ins = sum(a.numel() for a in args[:17] if _is_array(a))
        outs = 3 * n * nb * b + 2 * 2 * b + 4 * b
        # per knot and iteration: rhs 70, two sweeps, A vt 42, relax 72;
        # the residuals once: about 160 per knot
        per_iter = 70 + 2 * _sweep_flops(nb) + 42 + 72
        return (ins + outs) * f, n * b * (iters * per_iter + 160)
    if name == "fused_structured_round":
        ci, ac, iters = args[0], args[2], args[11]
        n, nb, _, b = ci.shape
        r = ac.shape[1]
        ins = sum(a.numel() for a in args[:11])
        outs = n * b * (nb + 2 * r)
        per_iter = (2 * r + 2 * nb * (2 * r - 1) + 4 * nb
                    + 2 * _sweep_flops(nb) + r * (2 * (2 * nb - 1) + 1)
                    + 9 * r + 3 * nb)
        return (ins + outs) * f, n * b * iters * per_iter
    if name == "dp_forward":
        b, lm1, kp, k = args[0].shape
        ins = sum(a.numel() for a in args[:5])
        outs = 2 * b * lm1 * k
        return (ins + outs) * f + b * lm1, b * lm1 * kp * k * 11
    raise KeyError(name)


def bound_ms(name: str, args) -> tuple[float, str]:
    nbytes, flops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def admm_round_args(n: int, b: int, iters: int, nb: int = 6) -> tuple:
    """K2's argument list as shapes (``fused_rounds.fused_admm_round``):
    cc (N, 2, 2, B), Ci and Wp (N, 6, 6, B), tp (N, 3, 6, B), lbk and ubk
    (N, 6, B), lbe and ube (2, B), rk (N, 6, B), re (2, B), end_idx (B,),
    pd, v, zk (N, 6, B), ze (2, B), yk (N, 6, B), ye (2, B), iters."""
    S = Shape
    return (S(n, 2, 2, b), S(n, nb, nb, b), S(n, nb, nb, b), S(n, 3, nb, b),
            S(n, nb, b), S(n, nb, b), S(2, b), S(2, b), S(n, nb, b), S(2, b),
            S(b), S(n, nb, b), S(n, nb, b), S(n, nb, b), S(2, b),
            S(n, nb, b), S(2, b), iters)
