"""Scenario batching: one call solves a batch of problems on one device.

PyTorch counterpart of `solve_batch`, `solve_batch_staged`,
`solve_batch_al`, `solve_batch_al_staged`, `solve_batch_gn` and
`batch_specs` in the JAX package's `parallel/mesh.py`. A spec in the fleet's scope whose
per-scenario leaves are the initial state and the fleet's keypoint
overrides (`FLEET_OVERRIDES`) goes to the lane-major fleet solver
(`solvers/fleet.py`); built solvers are memoized by the spec's content, the
override names and `record` in a 32-entry LRU. `prefer_fleet=False`, and
any other spec, go to the recursive solver run over the batch
(`solvers/ilqr.py::_solve_impl`, the counterpart of the JAX package's vmap
over its single-problem solve), with the overridden leaves batched on the
spec (`batch_specs`). AL-iLQR routes alike: the AL fleet
(`fleet.make_fleet_solver_al`) takes a spec in the fleet's scope with
shared constraints and only the initial state per scenario, the batched
`solvers/al_ilqr.py` everything else. The route follows from the spec, the
override names, the constraints' shape and `prefer_fleet` alone: an error
in the fleet raises, it is never answered by the other solver.
"""

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict

import torch

from ilqr_planner_torch.solvers import al_ilqr, batch as batch_solver, ilqr
from ilqr_planner_torch.solvers.fleet import (FLEET_OVERRIDES, fleet_supported,
                                              make_fleet_solver,
                                              make_fleet_solver_al)
from ilqr_planner_torch.systems.spec import Spec, split_overrides

__all__ = ["solve_batch", "solve_batch_staged", "solve_batch_al",
           "solve_batch_al_staged", "solve_batch_gn", "batch_specs"]

_INITIAL = ("q0", "x0")


def batch_specs(spec: Spec, overrides: Dict[str, torch.Tensor]) -> Spec:
    """The spec with its per-scenario keypoint leaves attached: each
    override of FLEET_OVERRIDES (an array with a leading scenario axis)
    replaces that leaf, which then carries the scenario axis in front. For
    a sequential spec an override is a list with one entry a subsystem
    (None keeps that subsystem's leaf). The initial state ('x0', 'q0')
    travels beside the spec, not on it. Other leaves raise."""
    names = set(overrides) - set(_INITIAL)
    extra = sorted(names - set(FLEET_OVERRIDES))
    if extra:
        raise NotImplementedError(
            f"per-scenario overrides of {extra} are not ported (the port takes "
            f"{list(_INITIAL + FLEET_OVERRIDES)})")

    def leaf(v):
        return torch.as_tensor(v, dtype=spec.dtype, device=spec.device)

    parts = split_overrides(spec.kind, len(spec.subs),
                            {k: overrides[k] for k in names})
    if spec.kind != "sequential":
        return dataclasses.replace(spec, **{k: leaf(v) for k, v in parts[0].items()})
    return dataclasses.replace(spec, subs=tuple(
        dataclasses.replace(sub, **{k: leaf(v) for k, v in part.items()})
        for sub, part in zip(spec.subs, parts)))


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


def _digest(named):
    """sha1 of (name, tensor) pairs: each one's dtype, shape and bytes."""
    h = hashlib.sha1()
    for name, t in named:
        a = torch.as_tensor(t).detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _spec_fingerprint(spec: Spec):
    """Content hash of a Spec: its static fields, device and every tensor."""
    robots = [s.robot.kind if s.robot is not None else None
              for s in (spec.subs or (spec,))]
    static = (spec.kind, spec.nb_deriv, spec.horizon, spec.limits_set,
              tuple(robots), str(spec.device))
    return static, _digest(spec.tensors().items())


def _fleet_dispatch(spec: Spec, overrides) -> tuple:
    """(use_fleet, ov_names): the fleet takes the spec when it is in its
    scope and every override is the initial state or one of the keypoint
    leaves it binds to lanes."""
    ov_names = tuple(sorted(set(overrides) - set(_INITIAL)))
    if not set(ov_names) <= set(FLEET_OVERRIDES):
        return False, ()
    return fleet_supported(spec), ov_names


def solve_batch(spec: Spec, overrides: Dict[str, torch.Tensor], U0s,
                nb_iter: int, line_search: bool = True, early_stop: bool = True,
                prefer_fleet: bool = True, record: bool = False):
    """Solve a scenario batch of recursive-iLQR problems on the spec's device.

    U0s: [B, H-1, nu]. overrides: per-scenario Spec leaves with a leading
    axis B: the initial state ('x0', or 'q0' when no 'x0' is given) and the
    keypoint leaves 'mu', 'prec', 'pos_radius', 'orn_thresh' (for a
    sequential spec, lists with one entry a subsystem, None keeping that
    subsystem's leaf). Returns an ILQRResult with a leading scenario axis;
    `record=True` adds `progress`, each lane's {"cost", "alpha"}
    [B, nb_iter] at each of its iterations, NaN beyond its last.

    A spec in the fleet's scope runs the lane-major fleet solver; the two
    paths agree to rounding. `prefer_fleet=False` forces the recursive
    solver (`solvers.ilqr`), which also takes every spec the fleet does not.
    """
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    if U0s.dim() != 3 or tuple(U0s.shape[1:]) != (spec.horizon - 1, spec.nu):
        raise ValueError(f"U0s must be [B, {spec.horizon - 1}, {spec.nu}], got "
                         f"{tuple(U0s.shape)}")
    x0s = _fleet_x0s(spec, overrides, U0s)
    use, ov_names = (_fleet_dispatch(spec, overrides) if prefer_fleet
                     else (False, ()))
    if not use:
        return ilqr._solve_impl(batch_specs(spec, overrides), x0s, U0s,
                                int(nb_iter), bool(line_search),
                                bool(early_stop), bool(record))
    key = (_spec_fingerprint(spec), int(nb_iter), bool(line_search),
           bool(early_stop), ov_names, bool(record))
    solver = _fleet_cache_get(key)
    if solver is None:
        solver = make_fleet_solver(spec, int(nb_iter), bool(line_search),
                                   bool(early_stop), overrides=ov_names,
                                   record=bool(record))
        _fleet_cache_put(key, solver)
    if ov_names:
        return solver(x0s, U0s, {k: overrides[k] for k in ov_names})
    return solver(x0s, U0s)


def _gather(tree, idx):
    """Every tensor of a (nested list / dict) tree at the rows idx of its
    leading axis; None entries pass through."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _gather(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather(v, idx) for v in tree)
    return torch.as_tensor(tree, device=idx.device)[idx]


def solve_batch_staged(spec: Spec, overrides, U0s, nb_iter: int,
                       first_stage: int = 6, bucket: int = 512, **kw):
    """Straggler-aware batch solve with the results of
    solve_batch(..., nb_iter): every lane runs `first_stage` iterations;
    the lanes that used all of them are gathered (padded to a multiple of
    `bucket` with copies of the first) and solved again from their initial
    state with the full budget, and their results are scattered back. A
    lane's solve does not depend on the other lanes, and a lane that stopped
    early stops at the same iteration under any budget, so the result is
    the plain solve's. record=True raises: the two stages' progress buffers
    have different lengths."""
    if kw.get("record"):
        raise ValueError(
            "record=True is not supported by the staged schedule (the two "
            "stages' progress buffers have different lengths); use "
            "solve_batch(record=True)")
    first_stage = min(int(first_stage), int(nb_iter))
    res1 = solve_batch(spec, overrides, U0s, first_stage, **kw)
    idx, idx_p = _restage_lanes(res1, first_stage, nb_iter, bucket, spec.device)
    if idx is None:
        return res1
    ov2, U0_2 = _gather((dict(overrides), U0s), idx_p)
    return _scatter(res1, solve_batch(spec, ov2, U0_2, nb_iter, **kw), idx)


def _restage_lanes(res1, first_stage, nb_iter, bucket, device):
    """The lanes of a first-stage result that used every iteration (None
    when no second stage is needed) and their indices padded with copies of
    the first to a multiple of `bucket`."""
    idx = torch.nonzero(res1.iterations >= first_stage).flatten()
    if idx.numel() == 0 or first_stage >= nb_iter:
        return None, None
    pad = (-idx.numel()) % bucket
    return idx, torch.cat([idx, idx[:1].expand(pad)]).to(device)


def _scatter(res1, res2, idx):
    """res1 with the lanes idx replaced by the first len(idx) lanes of res2,
    field by field (None fields stay None)."""
    keep = idx.numel()
    out = {}
    for f in dataclasses.fields(res1):
        a, b = getattr(res1, f.name), getattr(res2, f.name)
        if a is None:
            out[f.name] = None
            continue
        a = a.clone()
        a[idx.to(a.device)] = b[:keep]
        out[f.name] = a
    return type(res1)(**out)


def _as_constraints(spec: Spec, constraints) -> al_ilqr.Constraints:
    """The constraints' A and b as tensors in the spec's dtype and device."""
    return al_ilqr.Constraints(*(
        torch.as_tensor(a, dtype=spec.dtype, device=spec.device)
        for a in (constraints.A, constraints.b)))


def solve_batch_al(spec: Spec, constraints, lam0, overrides, U0s,
                   nb_iter: int, lag_update_step: int, penalty: float,
                   scaling_factor: float, line_search: bool = True,
                   early_stop: bool = True, prefer_fleet: bool = True):
    """Solve a scenario batch of AL-iLQR problems on the spec's device.

    constraints: an `al_ilqr.Constraints`, shared by every scenario (A
    [H-1, nc, nx+nu], b [H-1, nc]) or per scenario (a leading axis B).
    lam0: [nc], [H-1, nc] or per scenario [B, H-1, nc]. overrides and U0s
    as in `solve_batch`. Returns an ALILQRResult with a leading scenario
    axis.

    A spec in the fleet's scope with shared constraints and no per-scenario
    leaf but the initial state runs the AL fleet
    (`fleet.make_fleet_solver_al`); `prefer_fleet=False`, and everything
    else, the batched recursive AL solver (`solvers.al_ilqr`) with the
    overridden leaves on the spec (`batch_specs`). The two routes agree to
    rounding.
    """
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    if U0s.dim() != 3 or tuple(U0s.shape[1:]) != (spec.horizon - 1, spec.nu):
        raise ValueError(f"U0s must be [B, {spec.horizon - 1}, {spec.nu}], got "
                         f"{tuple(U0s.shape)}")
    cons = _as_constraints(spec, constraints)
    x0s = _fleet_x0s(spec, overrides, U0s)
    lam0 = torch.as_tensor(lam0, dtype=spec.dtype, device=spec.device)
    if (prefer_fleet and cons.A.dim() != 4 and set(overrides) <= set(_INITIAL)
            and fleet_supported(spec)):
        key = (_spec_fingerprint(spec), "al", int(nb_iter), int(lag_update_step),
               float(penalty), float(scaling_factor), bool(line_search),
               bool(early_stop), _digest((("A", cons.A), ("b", cons.b))))
        solver = _fleet_cache_get(key)
        if solver is None:
            solver = make_fleet_solver_al(
                spec, cons, int(nb_iter), int(lag_update_step), float(penalty),
                float(scaling_factor), bool(line_search), bool(early_stop))
            _fleet_cache_put(key, solver)
        return solver(x0s, U0s, lam0)
    B, H = U0s.shape[0], spec.horizon
    if lam0.dim() < 3:
        lam0 = lam0.expand((B, H - 1) + tuple(lam0.shape[-1:]))
    return al_ilqr._solve_impl(batch_specs(spec, overrides), cons, lam0, x0s,
                               U0s, int(nb_iter), int(lag_update_step),
                               float(penalty), float(scaling_factor),
                               bool(line_search), bool(early_stop))


def solve_batch_al_staged(spec: Spec, constraints, lam0, overrides, U0s,
                          nb_iter: int, lag_update_step: int, penalty: float,
                          scaling_factor: float, first_stage: int = 30,
                          bucket: int = 512, **kw):
    """Straggler-aware AL batch solve with the results of
    solve_batch_al(..., nb_iter): every lane runs min(first_stage, nb_iter)
    iterations; the lanes that used all of them are gathered (padded to a
    multiple of `bucket` with copies of the first) with their overrides,
    controls, per-scenario duals and per-scenario constraints, solved again
    from their initial state with the full budget, and scattered back. A
    lane's solve does not depend on the other lanes, and a lane that stopped
    early stops at the same iteration under any budget."""
    first_stage = min(int(first_stage), int(nb_iter))
    res1 = solve_batch_al(spec, constraints, lam0, overrides, U0s, first_stage,
                          lag_update_step, penalty, scaling_factor, **kw)
    idx, idx_p = _restage_lanes(res1, first_stage, nb_iter, bucket, spec.device)
    if idx is None:
        return res1
    cons = _as_constraints(spec, constraints)
    lam0 = torch.as_tensor(lam0, dtype=spec.dtype, device=spec.device)
    ov2, U0_2 = _gather((dict(overrides), U0s), idx_p)
    lam2 = _gather(lam0, idx_p) if lam0.dim() == 3 else lam0
    cons2 = (al_ilqr.Constraints(*_gather((cons.A, cons.b), idx_p))
             if cons.A.dim() == 4 else cons)
    return _scatter(res1, solve_batch_al(spec, cons2, lam2, ov2, U0_2, nb_iter,
                                         lag_update_step, penalty,
                                         scaling_factor, **kw), idx)


def solve_batch_gn(spec: Spec, kp_idx, overrides: Dict[str, torch.Tensor],
                   u0s, nb_iter: int, psi=None, early_stop: bool = True):
    """Solve a scenario batch of batch (Gauss-Newton) iLQR problems on the
    spec's device: BatchILQR, or with the control-primitive basis `psi`
    [(H-1) nu, K nu] shared by every scenario, BatchILQRCP.

    u0s: [B, (H-1) nu] flattened controls. overrides: the initial state
    ('x0', or 'q0' when no 'x0' is given) and the keypoint leaves 'mu',
    'pos_radius', 'orn_thresh' with a leading axis B. A 'prec' override
    raises NotImplementedError: the keypoint precision Q of the
    Gauss-Newton system is built once from the spec, shared by every lane
    (the JAX package ignores a per-lane 'prec' there). Returns a
    `batch.BatchResult` with a leading scenario axis. The closed-form body
    runs whenever every Rt > 0 (`batch.fast_supported`).
    """
    if "prec" in overrides:
        raise NotImplementedError(
            "a per-scenario 'prec' override is not supported by "
            "solve_batch_gn: the Gauss-Newton system's keypoint precision is "
            "built once from the spec and shared by every lane")
    kp_idx = tuple(int(k) for k in kp_idx)
    u0s = torch.as_tensor(u0s, dtype=spec.dtype, device=spec.device)
    W = (spec.horizon - 1) * spec.nu
    if u0s.dim() != 2 or u0s.shape[1] != W:
        raise ValueError(f"u0s must be [B, {W}], got {tuple(u0s.shape)}")
    x0s = _fleet_x0s(spec, overrides, u0s)
    if psi is not None:
        psi = torch.as_tensor(psi, dtype=spec.dtype, device=spec.device)
    return batch_solver._solve_impl(
        batch_specs(spec, overrides), batch_solver.sparse_Q(spec, kp_idx),
        psi, x0s, u0s, kp_idx, int(nb_iter), bool(early_stop),
        psi is not None, batch_solver.fast_supported(spec))
