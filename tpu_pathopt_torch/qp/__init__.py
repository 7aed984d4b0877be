"""OSQP-semantics ADMM machinery: settings and the dense solver
(``admm``), the float64 NumPy oracle (``oracle``), block-tridiagonal
factor/solve (``btridiag``) and the generic block-banded structured engine
(``structured``)."""
