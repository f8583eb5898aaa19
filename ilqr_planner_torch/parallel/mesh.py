"""Scenario batching on one device, and sharded over ranks on a mesh.

PyTorch counterpart of the JAX package's `parallel/mesh.py`. A spec in the fleet's scope whose
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

A mesh (`make_mesh`) is a set of ranks, one process a card, with named
axes; a sharded solve (`solve_batch_sharded`) runs the same program on
every rank over its slice of the batch, and its collectives are
torch.distributed calls on the axis's process group. Without a process
group the mesh is one rank, whose collectives are the identity.
`solve_batch_chunked` solves fixed-size chunks one after another on one
device.
"""

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ilqr_planner_torch.solvers import al_ilqr, batch as batch_solver, ilqr
from ilqr_planner_torch.solvers.fleet import (FLEET_OVERRIDES, fleet_supported,
                                              make_fleet_solver,
                                              make_fleet_solver_al)
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems.spec import Spec, split_overrides
from ilqr_planner_torch.utils import compilemeter
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["make_mesh", "solve_batch", "solve_batch_staged", "solve_batch_al",
           "solve_batch_gn", "solve_batch_sharded", "batch_specs"]

_INITIAL = ("q0", "x0")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks with named axes, one process a card: `shape` maps each axis
    to its size, `device` is this rank's device, `device_mesh` torch's
    DeviceMesh over the world's ranks (None for one rank without a process
    group). A collective over an axis of one rank returns its input and
    launches nothing."""

    axis_names: tuple
    sizes: tuple
    device: torch.device
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def _group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over the ranks of `axis` (a new tensor)."""
        if self.shape[axis] == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self._group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' t concatenated along dim 0 in their order on `axis`."""
        if self.shape[axis] == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self._group(axis))
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The t of the rank at index 0 of `axis`, on every rank of it."""
        if self.shape[axis] == 1:
            return t
        t = t.clone()
        group = self._group(axis)
        dist.broadcast(t, src=dist.get_process_group_ranks(group)[0],
                       group=group)
        return t


def make_mesh(shape=None, axis_names=("dp",), device=None,
              devices=None) -> Mesh:
    """A mesh over the world's ranks, 1-D by default, on `device` (None:
    CUDA, this process's card), or on `devices`, one device a rank, of which
    this rank takes devices[rank]. Where a process group exists it is
    torch's DeviceMesh (`init_device_mesh`); without one, a one-rank mesh.
    Raises ValueError where the shape's product or the number of `devices`
    is not the world size, or where both `device` and `devices` are
    given."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None:
        if device is not None:
            raise ValueError("give make_mesh either device or devices, not "
                             "both")
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"make_mesh got {len(devices)} devices; the "
                             f"world has {world} ranks, one device a rank")
        device = devices[dist.get_rank() if dist.is_initialized() else 0]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, "
                         f"got {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks; "
                         f"the world has {world}")
    if not dist.is_initialized():
        return Mesh(axis_names, shape, dev)
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(axis_names, shape, dev,
                init_device_mesh(dev.type, shape, mesh_dim_names=axis_names))


# every leaf a scenario may carry on the spec: the fleet's keypoint leaves,
# then those that only the recursive, AL and Gauss-Newton routes take
LANE_LEAVES = FLEET_OVERRIDES + ("kp_mask", "Rt", "dt", "state_min",
                                 "state_max", "limit_weight", "penalty")


def batch_specs(spec: Spec, overrides: Dict[str, torch.Tensor]) -> Spec:
    """The spec with its per-scenario leaves attached: each override of
    LANE_LEAVES (an array with a leading scenario axis) replaces that leaf,
    which then carries the scenario axis in front. For a sequential spec an
    override is a list with one entry a subsystem (None keeps that
    subsystem's leaf); 'Rt' may also be an array, the top level's (the
    solver's gradient and Hessian in u; each subsystem's own Rt prices its
    cost), and a sequential spec follows subsystem 0's 'dt'. The initial
    state ('x0', 'q0') travels beside the spec, not on it.

    A per-lane 'kp_mask' also zeroes the precisions at the steps where no
    lane and no subsystem keeps a keypoint: the JAX package quadratizes at
    the union of the keypoint steps (`static_kp_steps`) only. 'dq0' (read
    by no solver), any other name, and a leaf of the wrong shape raise
    ValueError."""
    names = set(overrides) - set(_INITIAL)
    if "dq0" in names:
        raise ValueError("no solver reads 'dq0': pass the per-scenario "
                         "initial state as 'x0' ([q0, dq0] at nb_deriv 2)")
    unknown = sorted(names - set(LANE_LEAVES))
    if unknown:
        raise ValueError(f"unknown per-scenario overrides {unknown}; a "
                         f"scenario may carry {list(_INITIAL + LANE_LEAVES)}")
    seq = spec.kind == "sequential"
    top = {k: overrides[k] for k in names
           if seq and k == "Rt" and not isinstance(overrides[k], (list, tuple))}
    parts = split_overrides(spec.kind, len(spec.subs),
                            {k: overrides[k] for k in names - set(top)})

    def attach(s: Spec, part) -> Spec:
        rep = {}
        for name, v in part.items():
            want = tuple(getattr(s, name).shape)
            v = torch.as_tensor(v, dtype=spec.dtype, device=spec.device)
            if v.dim() != len(want) + 1 or tuple(v.shape[1:]) != want:
                raise ValueError(f"override {name!r} must be [B"
                                 f"{''.join(f', {d}' for d in want)}], got "
                                 f"{tuple(v.shape)}")
            rep[name] = v
        return dataclasses.replace(s, **rep)

    if not seq:
        return _union_precisions(attach(spec, parts[0]))
    return _union_precisions(dataclasses.replace(
        attach(spec, top),
        subs=tuple(attach(sub, part) for sub, part in zip(spec.subs, parts))))


def _union_precisions(spec: Spec) -> Spec:
    """Where some kp_mask carries the scenario axis: every precision zeroed
    at the steps where no lane of any subsystem has a keypoint (the same
    spec otherwise)."""
    subs = spec.subs if spec.kind == "sequential" else (spec,)
    if not any(s.kp_mask.dim() > 1 for s in subs):
        return spec
    H = spec.horizon
    live = torch.stack([(s.kp_mask != 0).reshape(-1, H).any(0) for s in subs])
    m = live.any(0).to(spec.dtype)[:, None, None]
    subs = tuple(dataclasses.replace(s, prec=s.prec * m) for s in subs)
    return subs[0] if spec.kind != "sequential" else dataclasses.replace(
        spec, subs=subs)


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
        with compilemeter.span("solver_build"):
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
            with compilemeter.span("solver_build"):
                solver = make_fleet_solver_al(
                    spec, cons, int(nb_iter), int(lag_update_step),
                    float(penalty), float(scaling_factor), bool(line_search),
                    bool(early_stop))
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


def _cat_results(parts):
    """Results of consecutive lane ranges -> one result, field by field
    along the scenario axis (None fields stay None)."""
    first = parts[0]
    return type(first)(**{
        f.name: None if getattr(first, f.name) is None
        else torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first)})


def solve_batch_chunked(spec: Spec, overrides: Dict[str, torch.Tensor], U0s,
                        nb_iter: int, chunk: int = 768,
                        line_search: bool = True, early_stop: bool = True):
    """A large scenario batch as fixed-size chunks of the recursive route
    (`solve_batch(..., prefer_fleet=False)`), solved one after another on
    the spec's device: the working memory is one chunk's. B must be a
    multiple of `chunk` (else ValueError). The overrides are chunked with
    their lanes, a sequential spec's lists entry by entry. Each lane is
    its lane of the unchunked recursive solve (to rounding: a batch of
    another size may reduce in another order)."""
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    B = U0s.shape[0]
    if B % chunk:
        raise ValueError(f"batch {B} must be a multiple of chunk {chunk}")
    parts = []
    for lo in range(0, B, chunk):
        idx = torch.arange(lo, lo + chunk, device=spec.device)
        ov, U0 = _gather((dict(overrides), U0s), idx)
        parts.append(solve_batch(spec, ov, U0, nb_iter, line_search,
                                 early_stop, prefer_fleet=False))
    return _cat_results(parts)


def _shard(mesh: Mesh, axis: str, overrides, U0s, device):
    """This rank's contiguous B / n lanes of the overrides (a sequential
    spec's lists entry by entry) and of U0s, n the size of `axis`; raises
    ValueError unless n divides B."""
    B, n = U0s.shape[0], mesh.shape[axis]
    if B % n:
        raise ValueError(f"batch {B} must be a multiple of the {axis!r} "
                         f"axis size {n}")
    lo = mesh.index(axis) * (B // n)
    return _gather((dict(overrides), U0s),
                   torch.arange(lo, lo + B // n, device=device))


def solve_batch_sharded(spec: Spec, overrides: Dict[str, torch.Tensor], U0s,
                        nb_iter: int, mesh: Optional[Mesh] = None,
                        axis: str = "dp", line_search: bool = True,
                        early_stop: bool = True, prefer_fleet: bool = True):
    """Shard the scenario batch over the ranks of a mesh axis: each rank
    solves its contiguous B / n lanes with `solve_batch` (the memoized
    lane-major fleet for a spec and overrides in its scope, else the
    recursive route) and stops on its own; the results are all-gathered,
    so every rank returns the whole batch. B must be a multiple of n (else
    ValueError). `mesh` defaults to `make_mesh()` on the spec's device; on
    an axis of one rank this is `solve_batch`, with no collective."""
    mesh = mesh or make_mesh(device=spec.device)
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    ov, U0 = _shard(mesh, axis, overrides, U0s, spec.device)
    res = solve_batch(spec, ov, U0, nb_iter, line_search, early_stop,
                      prefer_fleet)
    return type(res)(**{
        f.name: None if getattr(res, f.name) is None
        else mesh.all_gather(getattr(res, f.name), axis)
        for f in dataclasses.fields(res)})


def _lane_spec(spec: Spec, overrides, i: int):
    """(spec, x0 [nx]) of scenario i: the spec with lane i of every
    override attached (no scenario axis) and lane i's initial state."""
    spec_b = batch_specs(spec, overrides)

    def one(s: Spec) -> Spec:
        return dataclasses.replace(s, **{
            k: getattr(s, k)[i] for k in funcs._LEAF_DIMS
            if getattr(s, k) is not None and funcs.lane_leaf(s, k)})

    out = one(spec_b)
    if spec.kind == "sequential":
        out = dataclasses.replace(out, subs=tuple(one(s) for s in spec_b.subs))
    x0s = overrides.get("x0", overrides.get("q0"))
    return out, (spec.x0 if x0s is None
                 else _fleet_x0s(spec, {"x0": x0s}, None)[i])
