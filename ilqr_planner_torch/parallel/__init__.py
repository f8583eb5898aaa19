"""Scenario batching."""

from ilqr_planner_torch.parallel.mesh import (batch_specs, solve_batch,
                                              solve_batch_al,
                                              solve_batch_al_staged,
                                              solve_batch_gn,
                                              solve_batch_staged)

__all__ = ["batch_specs", "solve_batch", "solve_batch_al",
           "solve_batch_al_staged", "solve_batch_gn", "solve_batch_staged"]
