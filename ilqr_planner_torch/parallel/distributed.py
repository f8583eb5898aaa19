"""Multi-process runtime: one process per card, the same program on every
rank (torch.distributed).

PyTorch counterpart of the JAX package's `parallel/distributed.py`. Scenario
batches shard over the ranks on a mesh axis (`mesh.make_mesh`); only the
final gathers and the metric reductions cross the interconnect.

Typical launch, the same script on every rank (torchrun sets RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT; or pass them):

    from ilqr_planner_torch.parallel import distributed, make_mesh
    distributed.initialize()           # reads the environment, or the args
    mesh = make_mesh()                 # 1-D over every rank
    ... solve_batch_sharded(..., mesh=mesh)
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["initialize", "is_initialized", "process_summary"]

_initialized = False
# the environment variables that name a coordinator (torchrun sets them)
_COORDINATOR_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None) -> None:
    """Join the process group once (later calls return at once).

    With no coordinator given and none in the environment (MASTER_ADDR, or
    torchrun's RANK / WORLD_SIZE) this is single-process mode, a no-op, so
    the same script runs everywhere. Else the backend follows `device`
    (None: CUDA): `nccl` for CUDA, `gloo` for "cpu"; CUDA without a card
    raises, it never falls back to gloo. `coordinator_address` is
    "host:port" (TCP) or a URL ("tcp://...", "file://..."); without it the
    environment's MASTER_ADDR / MASTER_PORT are read. `num_processes` and
    `process_id` default to WORLD_SIZE and RANK."""
    global _initialized
    if _initialized:
        return
    if (coordinator_address is None and num_processes is None
            and not any(k in os.environ for k in _COORDINATOR_ENV)):
        _initialized = True                      # single-process mode
        return
    dev = resolve_device(device)
    if not dist.is_initialized():
        if coordinator_address is None:
            url = "env://"
        elif "://" in coordinator_address:
            url = coordinator_address
        else:
            url = f"tcp://{coordinator_address}"
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else os.environ["RANK"])
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=url, world_size=world, rank=rank)
    if dev.type == "cuda" and dev.index is None:
        # one card a process: the local rank's (LOCAL_RANK, else the rank)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    _initialized = True


def is_initialized() -> bool:
    """True after initialize() has run in this process."""
    return _initialized


def process_summary() -> dict:
    """The ranks' topology for logging, under the JAX package's keys: this
    process's rank and the number of processes, and its devices and the
    world's (one card a process)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
