"""Lateral path QP: structured assembly, the QP kernels' wrappers and the
two-pass SQP solver."""
