"""Solvers: the recursive iLQR and AL-iLQR solvers over a batch, and the
lane-major fleet solver."""

from ilqr_planner_torch.solvers import al_ilqr, fleet, ilqr
from ilqr_planner_torch.solvers.al_ilqr import ALILQRResult, Constraints
from ilqr_planner_torch.solvers.ilqr import ILQRResult

__all__ = ["al_ilqr", "fleet", "ilqr", "ALILQRResult", "Constraints",
           "ILQRResult"]
