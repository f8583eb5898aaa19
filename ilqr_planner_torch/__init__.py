"""PyTorch/CUDA port of the JAX iLQR package: batched iLQR trajectory
optimization with the scenario batch as the trailing (lane) axis.

The module tree mirrors the JAX package (ops, models, systems, solvers,
parallel, utils, compat: the reference's PyLQR API). Entry points run on
CUDA unless the caller passes `device="cpu"`; the hand-written kernels live
in `csrc/` and are built with nvcc at first use.
"""

from ilqr_planner_torch import compat, utils

__all__ = ["compat", "utils"]
