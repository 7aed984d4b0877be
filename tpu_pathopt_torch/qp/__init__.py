"""OSQP-semantics ADMM machinery: settings, block-tridiagonal factor/solve
and the generic block-banded structured engine."""
