"""Scenario batching: one call solves a batch of problems on one device.

PyTorch counterpart of `solve_batch` in the JAX package's `parallel/mesh.py`.
A spec in the fleet's scope goes to the lane-major fleet solver
(`solvers/fleet.py`); built solvers are memoized by the spec's content in a
32-entry LRU. `prefer_fleet=False`, and any spec the fleet does not take, go
to the recursive solver run over the batch (`solvers/ilqr.py::_solve_impl`,
the counterpart of the JAX package's vmap over its single-problem solve).
Keypoint overrides and `record=True` are ROADMAP S2.5's open part, and raise
until then.
"""

import hashlib
from collections import OrderedDict
from typing import Dict

import torch

from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.solvers.fleet import fleet_supported, make_fleet_solver
from ilqr_planner_torch.systems.spec import Spec

__all__ = ["solve_batch"]

_LATER = "is not ported yet (ROADMAP S2.5)"


def _fleet_x0s(spec: Spec, overrides, U0s):
    """Initial-state lanes [B, n]: the x0/q0 override when given, else the
    spec's own x0 broadcast over the batch. A state has n columns: [q],
    [q, dq] (double integrator) or [q, t] (time-optimal)."""
    x0s = overrides.get("x0", overrides.get("q0"))
    if x0s is None:
        B = U0s.shape[0]
        return spec.x0.expand(B, -1)
    x0s = torch.as_tensor(x0s, dtype=spec.dtype, device=spec.device)
    if x0s.shape[-1] != spec.nx:
        raise ValueError(f"initial states need {spec.nx} columns for kind "
                         f"{spec.kind!r} at nb_deriv={spec.nb_deriv}; got "
                         f"{tuple(x0s.shape)} (pass 'x0')")
    return x0s


# Built-solver memo, LRU-bounded: a long-lived service sweeping many
# distinct specs must not keep every solver's constants forever.
_FLEET_CACHE_MAX = 32
_fleet_cache: "OrderedDict[tuple, object]" = OrderedDict()


def _fleet_cache_get(key):
    solver = _fleet_cache.get(key)
    if solver is not None:
        _fleet_cache.move_to_end(key)
    return solver


def _fleet_cache_put(key, solver):
    _fleet_cache[key] = solver
    _fleet_cache.move_to_end(key)
    while len(_fleet_cache) > _FLEET_CACHE_MAX:
        _fleet_cache.popitem(last=False)


def _spec_fingerprint(spec: Spec):
    """Content hash of a Spec: its static fields, device and every tensor."""
    h = hashlib.sha1()
    for name, t in spec.tensors().items():
        a = t.detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    static = (spec.kind, spec.nb_deriv, spec.horizon, spec.limits_set,
              spec.robot.kind, str(spec.device))
    return static, h.hexdigest()


def solve_batch(spec: Spec, overrides: Dict[str, torch.Tensor], U0s,
                nb_iter: int, line_search: bool = True, early_stop: bool = True,
                prefer_fleet: bool = True, record: bool = False):
    """Solve a scenario batch of recursive-iLQR problems on the spec's device.

    U0s: [B, H-1, nu]. overrides: per-scenario Spec leaves with a leading
    axis B; only the initial state ('x0', or 'q0' when no 'x0' is given) is
    taken so far. Returns an ILQRResult with a leading scenario axis.

    A spec in the fleet's scope runs the lane-major fleet solver; the two
    paths agree to rounding. `prefer_fleet=False` forces the recursive
    solver (`solvers.ilqr`), which also takes every spec the fleet does not.
    The route follows from the spec and `prefer_fleet` alone: an error in the
    fleet's dispatch or solve propagates, it is never answered by the other
    solver.
    """
    if record:
        raise NotImplementedError(f"record=True {_LATER}")
    extra = tuple(sorted(set(overrides) - {"q0", "x0"}))
    if extra:
        raise NotImplementedError(f"keypoint overrides {extra} {_LATER}")
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    if U0s.dim() != 3 or tuple(U0s.shape[1:]) != (spec.horizon - 1, spec.nu):
        raise ValueError(f"U0s must be [B, {spec.horizon - 1}, {spec.nu}], got "
                         f"{tuple(U0s.shape)}")
    x0s = _fleet_x0s(spec, overrides, U0s)
    if not (prefer_fleet and fleet_supported(spec)):
        return ilqr._solve_impl(spec, x0s, U0s, int(nb_iter),
                                bool(line_search), bool(early_stop))
    key = (_spec_fingerprint(spec), int(nb_iter), bool(line_search),
           bool(early_stop))
    solver = _fleet_cache_get(key)
    if solver is None:
        solver = make_fleet_solver(spec, int(nb_iter), bool(line_search),
                                   bool(early_stop))
        _fleet_cache_put(key, solver)
    return solver(x0s, U0s)
