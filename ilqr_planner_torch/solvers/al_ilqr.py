"""Augmented-Lagrangian iLQR for per-step inequality constraints
A_k [x; u] <= b_k, written over a batch.

PyTorch counterpart of the JAX package's `solvers/al_ilqr.py` (its
FK-sparse body `_solve_body_sparse`). Like `solvers/ilqr.py::_solve_impl`,
one body serves `solve` (a batch of one) and
`parallel.solve_batch_al` on its recursive route: every tensor carries the
scenario batch B as its LEADING axis, and the constraints may carry it too
(A [B, H-1, nc, nx+nu]).

Semantics held:
  * the active set Ik is 1 except where g < 0 and lambda == 0, scaled by
    the current penalty;
  * the backward pass adds the constraint terms to every Q block
    (`_backward_core_al`), with the active sets captured after the
    PREVIOUS accepted rollout, so the penalty it sees lags a dual update;
  * the line search accepts on the plain cost, not the augmented
    Lagrangian (the trials of `ilqr._line_search`);
  * the active sets of the next backward pass come from the accepted
    trajectory with the pre-update lambda and penalty;
  * every `lag_update_step` iterations: penalty *= scaling_factor, then
    lambda = max(0, lambda + penalty g);
  * early stop alpha sqrt(sum ||du||) < 1e-3, without the plain solver's
    cost < 1e-3 condition. A stopped lane freezes.

Zero constraint rows are inert. The hooks are `ilqr.solve`'s:
`guard=True` keeps a lane's incumbent X, U and cost where its line search
floors out, and stops the lane (the duals still take that iteration's
update, as in the JAX package); `callback` hears of lane 0's (plain cost,
alpha) after each outer iteration.
"""

import dataclasses
from typing import Optional

import torch

from ilqr_planner_torch.ops.linalg import solve_spd
from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems.funcs import _mv
from ilqr_planner_torch.systems.spec import Spec
from ilqr_planner_torch.utils.callbacks import emit_progress
from ilqr_planner_torch.utils.compilemeter import host_read
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["Constraints", "ALILQRResult", "solve"]


@dataclasses.dataclass
class Constraints:
    """Per-step inequality constraints A_k [x; u] <= b_k: A [H-1, nc,
    nx+nu], b [H-1, nc] (a leading scenario axis on the batch route)."""

    A: torch.Tensor
    b: torch.Tensor

    @staticmethod
    def uniform(A, b, horizon: int, dtype=torch.float64,
                device=None) -> "Constraints":
        """The same rows A [nc, nx+nu], b [nc] at every step, on `device`
        (None: CUDA)."""
        dev = resolve_device(device)
        A = torch.as_tensor(A, dtype=dtype, device=dev)
        b = torch.as_tensor(b, dtype=dtype, device=dev)
        return Constraints(A=A.expand((horizon - 1,) + tuple(A.shape)),
                           b=b.expand((horizon - 1,) + tuple(b.shape)))


@dataclasses.dataclass
class ALILQRResult:
    """X [.., H, nx], fX [.., H, nt], U [.., H-1, nu], multipliers
    [.., H-1, nc], final (plain) cost and iterations used; `progress`
    {"cost", "alpha"} [.., nb_iter] with solve(record=True)."""

    X: torch.Tensor
    fX: torch.Tensor
    U: torch.Tensor
    multipliers: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor
    progress: Optional[dict] = None


def _active_sets(cons: Constraints, lam, penalty, X, U):
    """Penalty-scaled active sets and violations (Is, g) [B, H-1, nc] of
    trajectories X [B, H, nx], U [B, H-1, nu] at duals lam [B, H-1, nc] and
    penalty [B] (or a float). The violation is an elementwise product and
    sum: no reduced-precision matmul touches g, where AL converges."""
    XU = torch.cat([X[:, :-1], U], dim=-1)                 # [B, H-1, nx+nu]
    g = (cons.A * XU[..., None, :]).sum(-1) - cons.b
    inactive = (g < 0) & (lam == 0)
    pen = torch.as_tensor(penalty, dtype=X.dtype, device=X.device)
    pen = pen.reshape(pen.shape + (1, 1))
    return pen * torch.where(inactive, 0.0, 1.0).to(X.dtype), g


def _backward_core_al(spec: Spec, As, Bs, l_x, l_u, l_xx, lN_x, lN_xx,
                      ckx, cku, Is, Cs, lam):
    """The AL backward pass from quadratized stage terms (`ilqr._stage_terms`,
    [B, H-1, ...]): the recursion of `ilqr._backward_core` with the
    constraint terms added to every Q block. ckx [.., H-1, nc, nx] and cku
    [.., H-1, nc, nu] are the constraint rows, Is / Cs / lam [B, H-1, nc]
    the penalty-scaled active sets, violations and duals. As/Bs are per-step
    arrays, or () for the LTI kinds; the first-order LTI kinds (A = I,
    B = dt I) take the diagonal shortcut. -> (Ks [B, H-1, nu, nx],
    ds [B, H-1, nu])."""
    nu = spec.nu
    dtype, dev = l_x.dtype, l_x.device
    Hm1 = l_x.shape[1]
    R = torch.diag_embed(spec.Rt.to(dtype))        # [nu, nu] or [B, nu, nu]
    eye_reg = ilqr._REG * torch.eye(nu, dtype=dtype, device=dev)
    const_ab = funcs.constant_AB(spec, dtype) if isinstance(As, tuple) else None
    base = funcs.base_spec(spec)
    diag_lti = (const_ab is not None and base.nb_deriv == 1
                and not base.time_optimal)
    if diag_lti:
        # dt against P [B, nx, nx] and against p [B, nx]; one a lane or shared
        dt = base.dt.to(dtype)
        dt_m, dt_v = (dt[:, None, None], dt[:, None]) if dt.dim() else (dt, dt)

    P, p = lN_xx, lN_x
    Ks = l_x.new_empty((l_x.shape[0], Hm1, nu, spec.nx))
    ds = l_x.new_empty((l_x.shape[0], Hm1, nu))
    for t in range(Hm1 - 1, -1, -1):
        cx, cu = ckx[..., t, :, :], cku[..., t, :, :]
        Ik, g, lam_k = Is[:, t], Cs[:, t], lam[:, t]
        cxT, cuT = cx.transpose(-1, -2), cu.transpose(-1, -2)
        Icx = Ik[..., None] * cx
        Icu = Ik[..., None] * cu
        lig = lam_k + Ik * g
        if diag_lti:
            Qux = dt_m * P + cuT @ Icx
            Quu = R + dt_m * dt_m * P + cuT @ Icu
            Qxx = l_xx[:, t] + P + cxT @ Icx
            Qu = l_u[:, t] + dt_v * p + _mv(cuT, lig)
            Qx = l_x[:, t] + p + _mv(cxT, lig)
        else:
            A, B = const_ab if const_ab is not None else (As[:, t], Bs[:, t])
            AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
            PA = P @ A
            Qux = BT @ PA + cuT @ Icx
            Quu = R + BT @ P @ B + cuT @ Icu
            Qxx = l_xx[:, t] + AT @ PA + cxT @ Icx
            Qu = l_u[:, t] + _mv(BT, p) + _mv(cuT, lig)
            Qx = l_x[:, t] + _mv(AT, p) + _mv(cxT, lig)
        Qxu = Qux.transpose(-1, -2)
        Kd = -solve_spd(Quu + eye_reg, torch.cat([Qux, Qu[..., None]], dim=-1))
        K, d = Kd[..., :-1], Kd[..., -1]
        KT = K.transpose(-1, -2)
        P = Qxx + KT @ Quu @ K + KT @ Qux + Qxu @ K
        p = Qx + _mv(KT, _mv(Quu, d)) + _mv(KT, Qu) + _mv(Qxu, d)
        Ks[:, t], ds[:, t] = K, d
    return Ks, ds


def _solve_impl(spec: Spec, cons: Constraints, lam0, x0s, U0s, nb_iter: int,
                lag_update_step: int, penalty: float, scaling_factor: float,
                line_search: bool, early_stop: bool,
                record: bool = False, guard: bool = False,
                callback=None) -> ALILQRResult:
    """The batched AL solve: x0s [B, nx], U0s [B, H-1, nu], lam0
    [B, H-1, nc], the constraints shared ([H-1, ..]) or per lane
    ([B, H-1, ..]), all on the spec's device -> ALILQRResult with a leading
    scenario axis; `guard` and `callback` as in `ilqr._solve_impl`."""
    H, nu, nx = spec.horizon, spec.nu, spec.nx
    B = x0s.shape[0]
    dev = x0s.device
    ckx, cku = cons.A[..., :nx], cons.A[..., nx:]
    X, U, cost, _ = ilqr._trial(spec, 0.0, x0s.new_zeros((B, H - 1, nu, nx)),
                                x0s.new_zeros((B, H - 1, nu)),
                                x0s.new_zeros((B, H, nx)), U0s, x0s)
    lam = lam0
    pen = torch.full((B,), penalty, dtype=X.dtype, device=dev)
    Is, Cs = _active_sets(cons, lam, pen, X, U)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    a_sched = ilqr._alpha_schedule(line_search)
    if record:
        rec_cost = cost.new_full((B, nb_iter), float("nan"))
        rec_alpha = rec_cost.clone()

    while True:
        active = ~done & (it < nb_iter)
        if not host_read(active.any()):
            break
        fX, Js = funcs.fx_jac(spec, X)
        As, Bs = ilqr._per_step_AB(spec, X, U)
        Ks, ds = _backward_core_al(spec, As, Bs,
                                   *ilqr._stage_terms(spec, X, fX, U, Js),
                                   ckx, cku, Is, Cs, lam)
        Xn, Un, costn, du_acc, alpha, ok = ilqr._line_search(
            spec, a_sched, Ks, ds, X, U, cost, x0s, active)
        if guard:
            Xn = torch.where(ilqr._lead(ok, X), Xn, X)
            Un = torch.where(ilqr._lead(ok, U), Un, U)
            costn = torch.where(ok, costn, cost)
        if callback is not None:
            emit_progress(callback, active, it, costn, alpha)
        Isn, Csn = _active_sets(cons, lam, pen, Xn, Un)
        update = ((it + 1) % lag_update_step) == 0
        pen_n = torch.where(update, pen * scaling_factor, pen)
        lam_n = torch.where(update[:, None, None],
                            torch.clamp_min(lam + pen_n[:, None, None] * Csn, 0.0),
                            lam)
        new_done = done
        if early_stop:
            new_done = done | (alpha * torch.sqrt(du_acc) < 1e-3)
        if guard:
            new_done = new_done | ~ok
        if record:
            rec_cost = ilqr._record(rec_cost, it, active, costn)
            rec_alpha = ilqr._record(rec_alpha, it, active, alpha)
        lead = ilqr._lead
        X = torch.where(lead(active, X), Xn, X)
        U = torch.where(lead(active, U), Un, U)
        Is = torch.where(lead(active, Is), Isn, Is)
        Cs = torch.where(lead(active, Cs), Csn, Cs)
        lam = torch.where(lead(active, lam), lam_n, lam)
        cost = torch.where(active, costn, cost)
        pen = torch.where(active, pen_n, pen)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, new_done, done)

    return ALILQRResult(X=X, fX=funcs.fx(spec, X), U=U, multipliers=lam,
                        cost=cost, iterations=it,
                        progress={"cost": rec_cost, "alpha": rec_alpha}
                        if record else None)


def solve(spec: Spec, constraints: Constraints, init_lambda, U0, nb_iter: int,
          lag_update_step: int, penalty: float, scaling_factor: float,
          line_search: bool = True, early_stop: bool = True,
          callback: Optional[object] = None, guard: bool = False,
          record: bool = False) -> ALILQRResult:
    """Solve one AL problem from the controls U0 [H-1, nu] and the duals
    init_lambda ([nc], or [H-1, nc]), on the spec's device (CUDA unless
    the spec was built with device="cpu").

    The signature is the JAX `solve`'s. `callback.notify(msg)` is called
    after each executed outer iteration ("Iteration i, Cost: c, alpha= a",
    the plain cost). `guard=True`: a floored-out line search with no finite
    improving trial keeps the incumbent trajectory and stops, instead of
    the reference's adoption of the last trial (AL-ILQR.cpp:149-199).
    `record=True` returns `progress`, {"cost": [nb_iter], "alpha":
    [nb_iter]} at each executed iteration and NaN beyond (it excludes
    `callback`).
    """
    ilqr._check_options(record=record, callback=callback)
    H = spec.horizon
    U0 = torch.as_tensor(U0, dtype=spec.dtype, device=spec.device)
    if tuple(U0.shape) != (H - 1, spec.nu):
        raise ValueError(f"U0 must be [{H - 1}, {spec.nu}], got "
                         f"{tuple(U0.shape)}")
    cons = Constraints(*(torch.as_tensor(a, dtype=spec.dtype, device=spec.device)
                         for a in (constraints.A, constraints.b)))
    lam0 = torch.as_tensor(init_lambda, dtype=spec.dtype, device=spec.device)
    lam0 = lam0.expand((H - 1,) + tuple(lam0.shape[-1:]))
    res = _solve_impl(spec, cons, lam0[None], spec.x0[None], U0[None],
                      int(nb_iter), int(lag_update_step), float(penalty),
                      float(scaling_factor), bool(line_search),
                      bool(early_stop), bool(record), bool(guard), callback)
    out = {f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)
           if f.name != "progress"}
    if record:
        out["progress"] = {k: v[0] for k, v in res.progress.items()}
    return ALILQRResult(**out)
