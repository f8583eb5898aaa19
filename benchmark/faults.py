"""Faults planted under the timed call, to show that the check fails a
broken timed path (`calibrate.py --faults` on the card at the cell's own
size; `tests/test_bench_faults.py` on a CPU at a small one):

  unchanged  the solve returns its starting state: U0 rolled out from x0,
             its cost, no iteration;
  half       half of each batch left out: those lanes are answered with
             their starting state;
  altered    every answer states the cost of its starting state, not of
             its trajectory, where the call produces it.

No cell runs on more than one chip, so there is no exchange between chips
to leave out. The starting state is the plain reference's rollout in
float32 (`reference/ilqr.py` with no iteration).
"""

import torch

from benchmark.reference import ilqr
from benchmark.reference.precision import Precision

KINDS = ("unchanged", "half", "altered")


def _start(cell, device):
    """x0s, U0s -> the starting state of a solve, as a solve's answer."""
    ref = cell.problem().reference_problem(cell.config, Precision(torch.float32, device))

    def start(x0s, U0s):
        out = ilqr.solve(ref, x0s.float(), U0s.float(), 0)
        out["iterations"] = torch.zeros_like(out["iterations"])
        return out
    return start


def wrap(kind, cell, device):
    """-> a function that wraps the timed call with the fault `kind`."""
    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r}; there are {KINDS}")
    start = _start(cell, device)

    def wrapper(call):
        def broken(x0s, U0s):
            out = call(x0s, U0s)
            s = start(x0s, U0s)
            if kind == "unchanged":
                return {k: s[k].to(v.dtype) for k, v in out.items()}
            if kind == "half":
                h = x0s.shape[0] // 2
                return {k: torch.cat([v[:h], s[k][h:].to(v.dtype)]) for k, v in out.items()}
            return dict(out, cost=s["cost"].to(out["cost"].dtype))
        return broken
    return wrapper
