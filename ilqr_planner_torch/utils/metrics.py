"""Structured solver metrics and profiling helpers.

The port's copy of the JAX package's `utils/metrics.py`. The reference's
observability is one formatted string per iteration ("Iteration i, Cost:
c, alpha= a", ILQRRecursive.cpp:167-168). `MetricsCallback` keeps that
channel and also accumulates structured records; `trace` wraps
`torch.profiler` for a timeline of the host and the card.
"""

import contextlib
import os
import time
from typing import List, Optional

import torch

from ilqr_planner_torch.utils.callbacks import CallBackMessage

__all__ = ["MetricsCallback", "trace"]


class MetricsCallback(CallBackMessage):
    """Parses solver progress messages into structured records.

    records: list of dicts {iteration, cost, alpha, wall_time} where
    wall_time is measured host-side between notifications.
    """

    def __init__(self, verbose: bool = False):
        self.records: List[dict] = []
        self.verbose = verbose
        self._t_last = time.time()

    def notify(self, msg: str) -> None:
        now = time.time()
        rec = {"wall_time": now - self._t_last}
        self._t_last = now
        try:
            rec["iteration"] = int(msg.split("Iteration ")[1].split(",")[0])
            rec["cost"] = float(msg.split("Cost: ")[1].split(",")[0])
            rec["alpha"] = float(msg.split("alpha= ")[1].split(",")[0])
        except (IndexError, ValueError):
            rec["raw"] = msg
        self.records.append(rec)
        if self.verbose:
            print(msg)

    @property
    def costs(self):
        return [r["cost"] for r in self.records if "cost" in r]

    @property
    def alphas(self):
        return [r["alpha"] for r in self.records if "alpha" in r]


def _sync():
    """Wait for the card's queued work when this process uses a card: the
    host clock would otherwise time the launches, not the work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a solve: `with trace('tb'): solve(...)` captures a
    `torch.profiler` trace of the host and (where a card is present) CUDA
    activities into `logdir/trace.json` (Chrome trace format); with
    logdir=None it is a timer printing the elapsed wall time, the card's
    queue drained before each reading of the clock."""
    if logdir is None:
        _sync()
        t0 = time.time()
        yield
        _sync()
        print(f"[trace] {time.time() - t0:.3f}s")
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
