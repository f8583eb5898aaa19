"""Scenario batching, meshes of ranks, sharded batch solves, the
multi-process runtime (torch.distributed)."""

from ilqr_planner_torch.parallel import distributed, spmd
from ilqr_planner_torch.parallel.mesh import (
    batch_specs,
    make_mesh,
    solve_batch,
    solve_batch_al,
    solve_batch_al_staged,
    solve_batch_chunked,
    solve_batch_gn,
    solve_batch_sharded,
    solve_batch_staged,
)

__all__ = [
    "batch_specs",
    "distributed",
    "make_mesh",
    "solve_batch",
    "solve_batch_al",
    "solve_batch_al_staged",
    "solve_batch_staged",
    "solve_batch_chunked",
    "solve_batch_gn",
    "solve_batch_sharded",
]
