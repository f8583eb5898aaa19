"""PyLQR-compatible API: the reference's Python binding surface, on the
port.

The port's counterpart of the JAX package's `compat/`: the reference's
pybind11 module `PyLQR` with its submodules sim / system / solver / utils
(bindings.cpp:48-908), with the same class names, constructor signatures
and snake_case methods, as stateful wrappers over the port's functional
core. A tutorial script switches by its import lines:

    from ilqr_planner_torch.compat.sim import KDLRobot
    from ilqr_planner_torch.compat.system import PosOrnPlannerSys, PosOrnKeypoint
    from ilqr_planner_torch.compat.solver import ILQRRecursive
    from ilqr_planner_torch.compat.utils import PythonCallbackMessage

The robots take a keyword-only `device=` (None: CUDA; it raises without a
card) and `dtype=` (float64, the reference's precision); the systems and
solvers built over a robot run on its device, and every result comes back
as numpy.
"""

from ilqr_planner_torch.compat import sim, solver, system, utils

__all__ = ["sim", "system", "solver", "utils"]
