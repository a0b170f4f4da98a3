"""PyTorch/CUDA port of the pylabfea_tpu device solver.

A second package beside the JAX reference ``pylabfea_tpu``: the same
structured-grid 2-D elastoplastic load step with a trained SVC yield
function, written in PyTorch, with the two hot kernels (the SVC decision
function + gradient and the matrix-free stiffness apply) hand-written in
CUDA C++ for Hopper (``csrc/``).  It imports ``torch`` and never ``jax``.

Module names mirror the JAX package (``ops/jtensors``, ``ops/constitutive``,
``ops/fe_kernels``, ``ops/multigrid``) so each function's reference is
easy to find.
"""
from pylabfea_tpu_torch import config  # noqa: F401  (sets the TF32 policy)

__all__ = ['config']
