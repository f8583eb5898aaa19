"""Fixed speed-calibration probe of the card and its host.

The port's paths are bound by the host's eager launches, and the host that
drives a card differs from one run to the next: the same code has run at
rates up to 2x apart. This probe is a fixed program in the same regime:
400 steps of lane-wide elementwise float32 work over a [8, 65536] tensor,
about 9 eager launches a step (no torch.compile, no CUDA graph, no fused
kernel). Its wall time `calib_s`, recorded beside a measured rate,
normalizes comparisons across runs:

    normalized_rate = solves_per_s * (calib_s / CALIB_NOMINAL_S)

A run with calib_s == 2x nominal ran 2x slow, and its raw rate should be
doubled before it is compared with a run at nominal speed.

The probe program (`probe_program`) is never changed once committed: a
change would make old and new times incomparable. If it must ever change,
the new one takes a version suffix beside it.
"""

import time

import torch

from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["calibration_probe", "CALIB_NOMINAL_S"]

# The probe's time on the card: chip_smoke.py's first calibration line
# (after the build) in its run of 2026-10-17 on one NVIDIA H100 80GB HBM3,
# 700.00 W (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader).
CALIB_NOMINAL_S = 0.02524199799999849

_STEPS = 400
_SHAPE = (8, 65536)


def probe_program(c: torch.Tensor):
    """The fixed probe on c [8, 65536] float32 -> (c.ravel()[:4] after the
    last step, the last step's sum of c[:1, :8])."""
    s = None
    for _ in range(_STEPS):
        c = c * 1.0000001 + 0.3 * torch.sin(c) - 0.1 * c * c * 0.001
        s = torch.sum(c[:1, :8])
    return c.ravel()[:4], s


def calibration_probe(repeats: int = 3, device=None) -> float:
    """Best-of-`repeats` wall seconds of the probe program, after one warm
    run, on `device` (None: the card; it raises without one). Each run
    starts from c filled with 0.5 and ends by fetching its four values and
    its last sum to the host."""
    dev = resolve_device(device)
    x = torch.full(_SHAPE, 0.5, dtype=torch.float32, device=dev)

    def run():
        head, last = probe_program(x)
        head.cpu(), last.cpu()

    run()
    best = float("inf")
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best
