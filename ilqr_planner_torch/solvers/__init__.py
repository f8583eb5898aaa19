"""Solvers: the recursive iLQR and AL-iLQR solvers over a batch, the
lane-major fleet solver, the batch (Gauss-Newton) iLQR with control
primitives, and the linear-quadratic tracker."""

from ilqr_planner_torch.solvers import al_ilqr, batch, fleet, ilqr, lqt
from ilqr_planner_torch.solvers.al_ilqr import ALILQRResult, Constraints
from ilqr_planner_torch.solvers.batch import BatchResult
from ilqr_planner_torch.solvers.ilqr import ILQRResult
from ilqr_planner_torch.solvers.lqt import LQT

__all__ = ["al_ilqr", "batch", "fleet", "ilqr", "lqt", "ALILQRResult",
           "BatchResult", "Constraints", "ILQRResult", "LQT"]
