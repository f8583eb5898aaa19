"""Recursive iLQR: the single-problem solver, written over a batch.

PyTorch counterpart of the JAX package's `solvers/ilqr.py`. One body
(`_solve_impl`) serves `solve` (a batch of one) and
`parallel.solve_batch(..., prefer_fleet=False)`: every tensor carries the
scenario batch B as its LEADING axis (X [B, H, nx], Ks [B, H-1, nu, nx]),
the layout of the JAX package's vmapped solve and of its results.

Per iteration:
  * the forward map, its Jacobian, the residuals and the limit terms are
    evaluated once over all B x H states (`systems/funcs.py`; a line-search
    trial evaluates the forward map alone, `funcs.fx`): the
    integrators are kinematics-free, so the state recursion itself is a loop
    of H-1 cheap batched steps (`_integrate`);
  * the backward pass (`_backward`): with backward='pscan' the generic
    quadratization (`_stage_terms`) and the cost-to-go quadratics of the
    parallel-prefix scan (`ops/pscan.py::lqr_cost_to_go`), the gains formed
    with the 1e-6-regularized `inv_spd`, as the JAX package does; else, for
    the structured first-order kinds
    (nb_deriv 1, not time-optimal: A = I, B = dt I, sequential specs of
    them included) the fused dense quadratization + Riccati sweep
    `ops/cuda_kernels/riccati.py` (the CUDA kernel for CUDA tensors, its
    plain twin on the CPU), whose precisions are the same for every lane;
    for every other kind, and for a per-scenario `prec`, `Rt` or `dt`, the
    generic recursion `_backward_core` in plain tensor ops with per-step A,
    B. The route follows from the spec and its per-scenario leaves alone;
  * the backtracking line search: trials at alpha = 1, 1/2, ..., 2^-10, each
    a closed-loop rollout; each lane adopts its FIRST trial with a strictly
    lower, non-NaN cost, and the 2^-10 trial when none passes; the walk stops
    once every live lane has accepted;
  * early stop per lane: alpha * sqrt(sum_k ||du_k||) < 1e-3 and
    cost < 1e-3 (the sum is of norms, not squared norms). A stopped lane
    freezes every field. The loop ends when every lane is frozen or at
    `nb_iter`.

Numerics held fixed: the Quu ridge 1e-6 and the leading minus sign of the
gains. The result's `ds` is scaled by the accepted alpha. `record=True`
adds `progress`, each lane's {"cost", "alpha"} at each of its iterations,
NaN beyond its last.

Per-scenario leaves (mu, prec, pos_radius, orn_thresh, kp_mask, Rt, dt,
state_min, state_max, limit_weight, penalty) enter as spec leaves with a
leading scenario axis (`parallel.mesh.batch_specs`). The riccati kernel
takes per-lane targets, dead zones, keypoint masks (through the masked
residual) and limits (through its [B, H, nx] limit terms); a per-lane
`prec`, `Rt` (the top level's) or `dt` (subsystem 0's) takes
`_backward_core`, since the kernel's precisions are shared and its Rt and
dt are host scalars.

The hooks of the JAX `solve`: `guard=True` is a per-lane mask (a lane
whose line search floors out without a finite, strictly lower trial keeps
its incumbent X, U and cost, and stops); `callback` is notified of lane 0's
(cost, alpha) after each of its iterations (the cost after the guard's
keep), on the caller's thread, with the JAX package's message, in one
read from the device an iteration; without a callback the only reads are
the loop tests.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ilqr_planner_torch.ops.cuda_kernels.riccati import riccati_backward
from ilqr_planner_torch.ops.linalg import inv_spd, solve_spd
from ilqr_planner_torch.ops.pscan import lqr_cost_to_go
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems.funcs import _mv
from ilqr_planner_torch.systems.spec import Spec
from ilqr_planner_torch.utils.callbacks import emit_progress
from ilqr_planner_torch.utils.compilemeter import host_read

__all__ = ["ILQRResult", "solve", "rollout", "static_kp_steps", "TRIALS"]

_REG = 1e-6  # Quu ridge

# Line-search trials run by recursive solves so far (each a closed-loop
# rollout of the whole batch).
TRIALS = 0


@dataclasses.dataclass
class ILQRResult:
    """X [.., H, nx], fX [.., H, nt], U [.., H-1, nu], Ks [.., H-1, nu, nx],
    ds [.., H-1, nu] (scaled by the accepted alpha), final cost, iterations
    used and the last alpha; a batched solve adds a leading scenario axis."""

    X: torch.Tensor
    fX: torch.Tensor
    U: torch.Tensor
    Ks: torch.Tensor
    ds: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor
    alpha: torch.Tensor
    progress: Optional[dict] = None


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

def _integrate(spec: Spec, alpha, Ks, ds, Xref, Uref, x0):
    """The closed-loop state recursion u_k = Uref_k + K_k (x_k - Xref_k) +
    alpha d_k over a batch -> (X [B, H, nx], U [B, H-1, nu], sum_k ||du_k||
    [B]). No forward kinematics enters it."""
    H = spec.horizon
    B = x0.shape[0]
    X = x0.new_empty((B, H, spec.nx))
    U = x0.new_empty((B, H - 1, spec.nu))
    du_acc = x0.new_zeros(B)
    X[:, 0] = x = x0
    for k in range(H - 1):
        du = _mv(Ks[:, k], x - Xref[:, k]) + alpha * ds[:, k]
        u = Uref[:, k] + du
        x = funcs._next_state(spec, x, u)
        X[:, k + 1], U[:, k] = x, u
        du_acc = du_acc + torch.sqrt((du * du).sum(-1))
    return X, U, du_acc


def _traj_cost(spec: Spec, X, fX, U):
    """Total cost [B] of trajectories: the stage costs of steps 0..H-2 and
    the final cost (the stage cost at H-1 with u = 0)."""
    ks = torch.arange(spec.horizon - 1, device=X.device)
    stages = funcs.stage_cost(spec, X[:, :-1], fX[:, :-1], U, ks)
    return stages.sum(-1) + funcs.final_cost(spec, X[:, -1], fX[:, -1])


def _per_step_AB(spec: Spec, X, U):
    """((), ()) for the LTI kinds, whose A and B are constant; the per-step
    (As [B, H-1, nx, nx], Bs [B, H-1, nx, nu]) of the time-optimal kinds."""
    if not spec.time_optimal:
        return (), ()
    _, As, Bs = funcs.dynamics(spec, X[:, :-1], U)
    return As, Bs


def rollout(spec: Spec, alpha, Ks, ds, Xref, Uref, x0=None):
    """Closed-loop rollout u_k = Uref_k + K_k (x_k - Xref_k) + alpha d_k from
    x0 (the spec's own when None), accumulating the stage costs and the sum
    of ||du_k||. With Ks = ds = 0 this is the plain initial rollout.

    Takes one problem (Uref [H-1, nu]) or a batch (Uref [B, H-1, nu], x0
    [B, nx]) and returns (X, fX, U, As, Bs, Js, cost, du_norm_sum); As and Bs
    are () for the LTI kinds.
    """
    single = Uref.dim() == 2
    x0 = spec.x0 if x0 is None else x0
    if single:
        Ks, ds, Xref, Uref, x0 = (a[None] for a in (Ks, ds, Xref, Uref, x0))
    elif x0.dim() == 1:
        x0 = x0.expand(Uref.shape[0], -1)
    X, U, du_acc = _integrate(spec, alpha, Ks, ds, Xref, Uref, x0)
    fX, Js = funcs.fx_jac(spec, X)
    As, Bs = _per_step_AB(spec, X, U)
    out = (X, fX, U, As, Bs, Js, _traj_cost(spec, X, fX, U), du_acc)
    if single:
        out = tuple(a if isinstance(a, tuple) else a[0] for a in out)
    return out


# ---------------------------------------------------------------------------
# backward pass
# ---------------------------------------------------------------------------

def _lane_prec(spec: Spec) -> bool:
    """True when the precisions carry a scenario axis (in a subsystem of a
    sequential spec too)."""
    specs = spec.subs if spec.kind == "sequential" else (spec,)
    return any(s.prec.dim() > 3 for s in specs)


def _riccati_route(spec: Spec) -> bool:
    """The kinds the riccati kernel takes: first order, not time-optimal,
    precisions, Rt and dt the same for every lane."""
    return (spec.nb_deriv == 1 and not spec.time_optimal
            and not _lane_prec(spec) and not funcs.lane_leaf(spec, "Rt")
            and not funcs.lane_leaf(funcs.base_spec(spec), "dt"))


def _limit_diag(spec: Spec, X):
    """(ld, lq) [B, H, nx] of the riccati kernel, which adds -ld lq to l_x
    and ld^2 to the diagonal of l_xx: the limit terms of the one spec (or
    subsystem) that sets limits, zeros where none does. Where several
    subsystems set limits, ld = sqrt(sum L^2) and lq = (sum L q) / ld (0
    where ld is 0): the summed terms to rounding."""
    specs = spec.subs if spec.kind == "sequential" else (spec,)
    limited = [s for s in specs if s.limits_set]
    if not limited:
        zero = torch.zeros_like(X)
        return zero, zero
    ks = torch.arange(spec.horizon, device=X.device)
    if len(limited) == 1:
        return funcs.limit_terms(limited[0], X, ks)
    _, Lq, L2 = funcs._limit_triplet(spec, X, ks)
    ld = torch.sqrt(L2)
    return ld, torch.where(ld > 0, Lq / torch.where(ld > 0, ld, 1.0), 0.0)


def _host_consts(spec: Spec):
    """(Rt as a tuple of floats, dt as a float) for the riccati route, read
    from the device once per solve; None for the kinds that route does not
    take."""
    if _riccati_route(spec):
        return tuple(spec.Rt.tolist()), float(funcs.base_spec(spec).dt)
    return None


def _backward(spec: Spec, X, fX, U, As, Bs, Js, pscan: bool = False,
              host=None):
    """Backward Riccati pass over a batch -> (Ks [B, H-1, nu, nx],
    ds [B, H-1, nu]). `host` is `_host_consts(spec)` when the caller holds
    it already (a solve reads it once, not once a sweep).

    The structured first-order kinds (nb_deriv 1, not time-optimal) with
    precisions, Rt and dt the same for every lane hand the dense per-step
    J, e, limit terms (`_limit_diag`) and precisions to `riccati_backward`:
    the CUDA kernel for CUDA tensors, its twin on the CPU. Every other
    kind, and a per-scenario `prec`, `Rt` or `dt`, quadratizes with
    `cost_gradients` and runs the generic recursion `_backward_core`;
    `pscan` quadratizes so for every kind and takes the parallel-prefix
    route of `_backward_core`.
    """
    if pscan:
        return _backward_core(spec, As, Bs,
                              *_stage_terms(spec, X, fX, U, Js), pscan=True)
    if _riccati_route(spec):
        ks = torch.arange(spec.horizon, device=X.device)
        e = funcs.residual(spec, fX, ks)
        ld, lq = _limit_diag(spec, X)
        prec = spec.prec if spec.kind != "sequential" else funcs.prec_at(spec, ks)
        Rt, dt = host or _host_consts(spec)
        return riccati_backward(
            Js.contiguous(), e.contiguous(), ld.contiguous(), lq.contiguous(),
            U.contiguous(), prec.contiguous(), Rt, dt, _REG)
    return _backward_core(spec, As, Bs, *_stage_terms(spec, X, fX, U, Js))


def _stage_terms(spec: Spec, X, fX, U, Js):
    """The quadratized costs of a batch of trajectories -> (l_x [B, H-1, nx],
    l_u [B, H-1, nu], l_xx [B, H-1, nx, nx]) of steps 0..H-2 and the
    terminal (lN_x, lN_xx), the stage terms at H-1 with u = 0."""
    ks = torch.arange(spec.horizon, device=X.device)
    U_pad = torch.cat([U, torch.zeros_like(U[:, :1])], dim=1)  # u = 0 at H-1
    l_x, l_u, l_xx = funcs.cost_gradients(spec, X, fX, Js, U_pad, ks)
    return l_x[:, :-1], l_u[:, :-1], l_xx[:, :-1], l_x[:, -1], l_xx[:, -1]


def _backward_core(spec: Spec, As, Bs, l_x, l_u, l_xx, lN_x, lN_xx,
                   pscan: bool = False):
    """Gains from precomputed quadratized stage terms (l_x [B, H-1, nx],
    l_u [B, H-1, nu], l_xx [B, H-1, nx, nx], terminal lN_x, lN_xx): the
    generic recursion, in plain tensor ops. As/Bs are per-step arrays, or ()
    for the LTI kinds (constant A, B). One elimination gives both gains:
    [K | d] = -(Quu + reg I)^-1 [Qux | Qu].

    `pscan`: the value quadratics (P_k, p_k) of the unregularized recursion
    from the associative scan of `ops/pscan.py` in O(log H) depth, then
    K = -(Quu + reg I)^-1 B^T P_{k+1} A and d = -(Quu + reg I)^-1
    (l_u + B^T p_{k+1}) with the explicit `inv_spd` inverse."""
    nu = spec.nu
    dtype, dev = l_x.dtype, l_x.device
    Hm1 = l_x.shape[1]
    R = torch.diag_embed(spec.Rt.to(dtype))        # [nu, nu] or [B, nu, nu]
    eye_reg = _REG * torch.eye(nu, dtype=dtype, device=dev)
    const_ab = funcs.constant_AB(spec, dtype) if isinstance(As, tuple) else None
    if pscan:
        if const_ab is not None:
            lead = l_x.shape[:2]
            As = const_ab[0].expand(*lead, spec.nx, spec.nx)
            Bs = const_ab[1].expand(*lead, spec.nx, nu)
        Ps, ps = lqr_cost_to_go(As, Bs, l_x, l_u, l_xx, lN_x, lN_xx,
                                spec.Rt.to(dtype))
        P1, p1 = Ps[:, 1:], ps[:, 1:]
        BT = Bs.transpose(-1, -2)
        Minv = -inv_spd(R + BT @ P1 @ Bs + eye_reg)
        return Minv @ (BT @ P1 @ As), _mv(Minv, l_u + _mv(BT, p1))

    P, p = lN_xx, lN_x
    Ks = l_x.new_empty((l_x.shape[0], Hm1, nu, spec.nx))
    ds = l_x.new_empty((l_x.shape[0], Hm1, nu))
    for t in range(Hm1 - 1, -1, -1):
        A, B = const_ab if const_ab is not None else (As[:, t], Bs[:, t])
        AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
        PA = P @ A
        Qux = BT @ PA
        Quu = R + BT @ P @ B
        Qxx = l_xx[:, t] + AT @ PA
        Qxu = Qux.transpose(-1, -2)
        Qu = l_u[:, t] + _mv(BT, p)
        Qx = l_x[:, t] + _mv(AT, p)
        Kd = -solve_spd(Quu + eye_reg, torch.cat([Qux, Qu[..., None]], dim=-1))
        K, d = Kd[..., :-1], Kd[..., -1]
        KT = K.transpose(-1, -2)
        P = Qxx + KT @ Quu @ K + KT @ Qux + Qxu @ K
        p = Qx + _mv(KT, _mv(Quu, d)) + _mv(KT, Qu) + _mv(Qxu, d)
        Ks[:, t], ds[:, t] = K, d
    return Ks, ds


def static_kp_steps(spec: Spec):
    """Keypoint timesteps as a tuple of ints, read from the spec's kp_mask
    (the union over any leading batch axes, and over the subsystems of a
    sequential spec)."""
    specs = spec.subs if spec.kind == "sequential" else (spec,)
    m = np.concatenate([
        (s.kp_mask.detach().cpu().numpy() != 0).reshape(-1, spec.horizon)
        for s in specs])
    return tuple(int(k) for k in np.nonzero(m.any(0))[0])


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def _lead(mask, like):
    """A [B] mask shaped to select whole lanes of `like` [B, ...]."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _record(buf, it, active, value):
    """Write value [B] at each active lane's iteration index it [B] of
    buf [B, nb_iter]."""
    cols = torch.arange(buf.shape[1], device=buf.device)[None, :]
    return torch.where((cols == it[:, None]) & active[:, None],
                       value[:, None], buf)


def _alpha_schedule(line_search: bool):
    """The line-search trials: alpha = 1, 1/2, ..., 2^-10, or 1 alone."""
    return [2.0 ** -i for i in range(11)] if line_search else [1.0]


def _trial(spec: Spec, a, Ks, ds, Xref, Uref, x0s):
    """One closed-loop rollout at alpha = a -> (X, U, cost [B], sum_k
    ||du_k|| [B]); the forward map alone prices it (no Jacobian)."""
    X, U, du_acc = _integrate(spec, a, Ks, ds, Xref, Uref, x0s)
    return X, U, _traj_cost(spec, X, funcs.fx(spec, X), U), du_acc


def _line_search(spec: Spec, a_sched, Ks, ds, X, U, cost, x0s, active):
    """Backtracking over `a_sched`: each active lane adopts its first trial
    with a strictly lower, non-NaN cost, and the last trial when none
    passes; frozen lanes start as accepted, and the walk stops once every
    lane has accepted. -> (X, U, cost, sum ||du||, alpha, accepted [B]:
    False where an active lane found no such trial)."""
    global TRIALS
    accepted = ~active
    best = (X, U, cost, torch.zeros_like(cost), torch.ones_like(cost))
    for a in a_sched:
        if host_read(accepted.all()):
            break
        Xt, Ut, ct, dut = _trial(spec, a, Ks, ds, X, U, x0s)
        TRIALS += 1
        ok = (ct < cost) & ~torch.isnan(ct)
        take = ~accepted
        best = tuple(torch.where(_lead(take, new), new, old) for old, new
                     in zip(best, (Xt, Ut, ct, dut, torch.full_like(ct, a))))
        accepted = accepted | ok
    return best + (accepted,)


def _solve_impl(spec: Spec, x0s, U0s, nb_iter: int, line_search: bool,
                early_stop: bool, record: bool = False,
                pscan: bool = False, guard: bool = False,
                callback=None) -> ILQRResult:
    """The batched solve: x0s [B, nx], U0s [B, H-1, nu] on the spec's device
    -> ILQRResult with a leading scenario axis; `record` fills `progress`
    ({"cost", "alpha"} [B, nb_iter], NaN beyond each lane's iterations);
    `pscan` takes the parallel-prefix backward pass; `guard` keeps a lane's
    incumbent where its line search floors out and stops the lane;
    `callback` hears of lane 0's iterations."""
    H, nu, nx = spec.horizon, spec.nu, spec.nx
    B = x0s.shape[0]
    dev = x0s.device
    host = _host_consts(spec)

    Ks = x0s.new_zeros((B, H - 1, nu, nx))
    ds = x0s.new_zeros((B, H - 1, nu))
    X, U, cost, _ = _trial(spec, 0.0, Ks, ds, x0s.new_zeros((B, H, nx)), U0s,
                           x0s)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    alpha = torch.ones_like(cost)
    a_sched = _alpha_schedule(line_search)
    if record:
        rec_cost = cost.new_full((B, nb_iter), float("nan"))
        rec_alpha = rec_cost.clone()

    while True:
        active = ~done & (it < nb_iter)
        if not host_read(active.any()):
            break
        fX, Js = funcs.fx_jac(spec, X)
        As, Bs = _per_step_AB(spec, X, U)
        Ks_n, ds_n = _backward(spec, X, fX, U, As, Bs, Js, pscan, host)

        Xn, Un, costn, du_acc, alpha_n, ok = _line_search(
            spec, a_sched, Ks_n, ds_n, X, U, cost, x0s, active)
        if guard:
            Xn = torch.where(_lead(ok, X), Xn, X)
            Un = torch.where(_lead(ok, U), Un, U)
            costn = torch.where(ok, costn, cost)
        if callback is not None:
            emit_progress(callback, active, it, costn, alpha_n)

        new_done = done
        if early_stop:
            new_done = done | ((alpha_n * torch.sqrt(du_acc) < 1e-3)
                               & (costn < 1e-3))
        if guard:
            new_done = new_done | ~ok
        if record:
            rec_cost = _record(rec_cost, it, active, costn)
            rec_alpha = _record(rec_alpha, it, active, alpha_n)
        X = torch.where(_lead(active, X), Xn, X)
        U = torch.where(_lead(active, U), Un, U)
        cost = torch.where(active, costn, cost)
        Ks = torch.where(_lead(active, Ks), Ks_n, Ks)
        ds = torch.where(_lead(active, ds), ds_n, ds)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, new_done, done)
        alpha = torch.where(active, alpha_n, alpha)

    return ILQRResult(X=X, fX=funcs.fx(spec, X), U=U, Ks=Ks,
                      ds=alpha[:, None, None] * ds, cost=cost, iterations=it,
                      alpha=alpha,
                      progress={"cost": rec_cost, "alpha": rec_alpha}
                      if record else None)


def _check_options(backward: str = "scan", record: bool = False,
                   callback=None):
    """Raise for contradictory arguments."""
    if backward not in ("scan", "pscan"):
        raise ValueError(f"backward must be 'scan' or 'pscan', got {backward!r}")
    if record and callback is not None:
        raise ValueError("record=True and callback are mutually exclusive")


def solve(spec: Spec, U0, nb_iter: int, line_search: bool = True,
          early_stop: bool = True, callback: Optional[object] = None,
          backward: str = "scan", guard: bool = False,
          record: bool = False) -> ILQRResult:
    """Solve the problem from the initial controls U0 [H-1, nu], on the
    spec's device (CUDA unless the spec was built with device="cpu").

    The signature is the JAX `solve`'s. `callback.notify(msg)` is called
    after each executed iteration with "Iteration i, Cost: c, alpha= a".
    `guard=True` (default off, for the reference's behavior): where every
    trial down to the alpha floor fails (NaN or not strictly lower), keep
    the incumbent trajectory and stop, instead of adopting the last trial;
    the result is then the best finite iterate. `record=True` returns
    `progress`, {"cost": [nb_iter], "alpha": [nb_iter]} at each executed
    iteration and NaN beyond (it excludes `callback`). `backward='pscan'`
    computes the backward pass's value quadratics by the parallel-prefix
    scan (`ops/pscan.py`) from the generic quadratization.
    """
    _check_options(backward, record, callback)
    U0 = torch.as_tensor(U0, dtype=spec.dtype, device=spec.device)
    if tuple(U0.shape) != (spec.horizon - 1, spec.nu):
        raise ValueError(f"U0 must be [{spec.horizon - 1}, {spec.nu}], got "
                         f"{tuple(U0.shape)}")
    res = _solve_impl(spec, spec.x0[None], U0[None], int(nb_iter),
                      bool(line_search), bool(early_stop), bool(record),
                      backward == "pscan", bool(guard), callback)
    out = {f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)
           if f.name != "progress"}
    if record:
        out["progress"] = {k: v[0] for k, v in res.progress.items()}
    return ILQRResult(**out)
