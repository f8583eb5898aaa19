"""PyTorch/CUDA port of the JAX iLQR package: batched iLQR trajectory
optimization with the scenario batch as the trailing (lane) axis.

The module tree mirrors the JAX package (ops, models, systems, solvers,
parallel, utils, compat: the reference's PyLQR API). Entry points run on
CUDA unless the caller passes `device="cpu"`; the hand-written kernels live
in `csrc/` and are built with nvcc at first use, so importing the package
needs neither a card nor nvcc.
"""

__version__ = "0.1.0"

from ilqr_planner_torch import (compat, models, ops, parallel, solvers,
                                systems, utils)

__all__ = ["models", "ops", "parallel", "solvers", "systems", "utils",
           "compat", "__version__"]
