"""Scenario batching."""

from ilqr_planner_torch.parallel.mesh import solve_batch

__all__ = ["solve_batch"]
