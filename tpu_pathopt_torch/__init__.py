"""tpu_pathopt_torch: the PyTorch/CUDA port of ``tpu_pathopt``.

The same batched path-optimization pipeline (``pipeline.solve_batch``) with
the same ``PlannerConfig`` and results, written in PyTorch, with every Pallas
TPU kernel of the JAX package rewritten as a hand-written CUDA C++ kernel for
Hopper (``csrc/``, built by ``kernels.py`` at first use). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``. This package imports
neither JAX nor ``tpu_pathopt``.
"""

__version__ = "0.1.0"

from tpu_pathopt_torch.config import DEFAULT_CONFIG, PlannerConfig  # noqa: F401
