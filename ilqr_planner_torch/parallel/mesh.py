"""Scenario batching: one call solves a batch of problems on one device.

PyTorch counterpart of `solve_batch` in the JAX package's `parallel/mesh.py`.
The batch goes to the lane-major fleet solver (`solvers/fleet.py`); built
solvers are memoized by the spec's content in a 32-entry LRU. The vmap
fallback over the single-problem solver, keypoint overrides and
`record=True` are ROADMAP slice 2, and raise until then.
"""

import hashlib
from collections import OrderedDict
from typing import Dict

import torch

from ilqr_planner_torch.solvers.fleet import fleet_supported, make_fleet_solver
from ilqr_planner_torch.systems.spec import Spec

__all__ = ["solve_batch"]

_SLICE_2 = "is not ported yet (ROADMAP slice 2)"


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


def _fleet_dispatch(spec: Spec, overrides) -> bool:
    """True when the spec is in fleet scope. Raises on any override other
    than the initial state: keypoint overrides are not ported yet."""
    extra = tuple(sorted(set(overrides) - {"q0", "x0"}))
    if extra:
        raise NotImplementedError(f"keypoint overrides {extra} {_SLICE_2}")
    return fleet_supported(spec)


def solve_batch(spec: Spec, overrides: Dict[str, torch.Tensor], U0s,
                nb_iter: int, line_search: bool = True, early_stop: bool = True,
                prefer_fleet: bool = True, record: bool = False):
    """Solve a scenario batch of recursive-iLQR problems on the spec's device.

    U0s: [B, H-1, nu]. overrides: per-scenario Spec leaves with a leading
    axis B; this slice takes only the initial state ('q0' / 'x0').
    Returns an ILQRResult with a leading scenario axis.
    """
    if record:
        raise NotImplementedError(f"record=True {_SLICE_2}")
    if not prefer_fleet:
        raise NotImplementedError(f"the vmap path (prefer_fleet=False) {_SLICE_2}")
    if not _fleet_dispatch(spec, overrides):
        raise NotImplementedError(
            f"the vmap fallback for kind={spec.kind!r} "
            f"nb_deriv={spec.nb_deriv} {_SLICE_2}")
    key = (_spec_fingerprint(spec), int(nb_iter), bool(line_search),
           bool(early_stop))
    solver = _fleet_cache_get(key)
    if solver is None:
        solver = make_fleet_solver(spec, int(nb_iter), bool(line_search),
                                   bool(early_stop))
        _fleet_cache_put(key, solver)
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    return solver(_fleet_x0s(spec, overrides, U0s), U0s)
