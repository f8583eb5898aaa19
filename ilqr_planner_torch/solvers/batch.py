"""Batch (least-squares) iLQR, plain and control-primitive-projected.

PyTorch counterpart of the JAX package's `solvers/batch.py` (reference:
BatchILQR.cpp:22-173, BatchILQRCP.cpp:21-176), written over a batch: every
tensor carries the scenario batch B as its LEADING axis (u [B, (H-1) nu],
initial states x0s [B, nx]), the layout of the JAX package's vmapped
solve. The solver works on keypoint rows only: the transfer matrix Su, the
residual Jacobian J and the limit blocks L are assembled over keypoint
timesteps and a dense Gauss-Newton step is taken in the full control vector
(or in the control-primitive weight space u = Psi w).

Two bodies, chosen by `_solve_impl(..., fast)`:
  * `_solve_body`, the reference-shaped one: an open-loop rollout, Su by
    the reference's growing-matrix recursion, the dense [(H-1) nu]^2 normal
    equations and the sequential backtracking line search. The JAX
    while_loops under vmap are per lane; here they are masked loops over
    the batch that run until every lane is done, finished lanes frozen. It
    reads one flag from the card a loop test (a line-search trial, an
    iteration).
  * `_solve_body_fast`, the closed-form one, run whenever every Rt > 0
    (`fast_supported`): states and Su at keypoint rows in closed form, FK
    at keypoint rows only, the Gauss-Newton step by the symmetric
    square-root (Woodbury) identity (plain) or the projected K nu system
    (CP), all 11 line-search trials at once on a leading trial axis, and
    `nb_iter` masked iterations. It has no data-dependent loop and reads
    nothing from the card inside its iterations; the solves' info is
    checked once after the solve.

Reproduced reference quirks (iteration parity with the JAX package):
  * the transfer recursion is seeded with a zero B-block and the keypoint
    row for timestep t captures the transfer matrix *before* the update at
    t: exact for LTI dynamics, the shifted-by-one sensitivity for the
    time-varying time-optimal B;
  * joint-limit blocks lag one step: slot i+1 holds the limit terms of the
    pre-step state x_i; a keypoint at step 0 gets zero limit rows;
  * cost0 uses the L of the Gauss-Newton assembly while line-search trials
    rebuild L from their own rollouts;
  * the line-search floor accepts the trial unconditionally at
    alpha < 1e-3.

Per-scenario leaves (`parallel.mesh.batch_specs`): the targets, dead
zones, keypoint masks and limits enter the residual and limit rows; a
per-lane `Rt` gives each lane its own control penalty diagonal, and a
per-lane `dt` (subsystem 0's) its own closed-form Su [B, rows, (H-1) nu]
and states. The keypoint precision Q is built once from the spec.

`callback=` is notified of lane 0's (cost before the step, alpha) after
each iteration, as the JAX package does, and, as there, a solve with a
callback runs the reference-shaped body.

Float32 matmuls must keep full precision: the port leaves
`torch.backends.cuda.matmul.allow_tf32` False and the float32 matmul
precision at "highest", their defaults. The Woodbury step scales V by
1/sqrt(Rt) (about 316 at Rt = 1e-5), and reduced precision is what broke
the algebraically equal push-through form on the TPU.
"""

import dataclasses
from typing import Optional, Sequence

import torch

from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems.spec import Spec
from ilqr_planner_torch.utils.callbacks import emit_progress
from ilqr_planner_torch.utils.compilemeter import host_read

__all__ = ["BatchResult", "solve", "solve_cp", "sparse_Q", "sparse_mu",
           "fast_supported"]


@dataclasses.dataclass
class BatchResult:
    """u [B, (H-1) nu] controls, cost [B] the last evaluated cost0 (the cost
    before the last step taken), iterations [B]; `solve` and `solve_cp`
    return one problem's, without the batch axis."""

    u: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor


def _mT(a):
    return a.transpose(-1, -2)


def _rdiag(spec: Spec, dtype):
    """The control penalty over the flattened controls, Rt tiled H-1 times:
    [(H-1) nu], or [B, (H-1) nu] for a per-lane Rt [B, nu]."""
    Rt = spec.Rt.to(dtype)
    return Rt.repeat((1,) * (Rt.dim() - 1) + (spec.horizon - 1,))


def _dt(spec: Spec, dtype, nd: int):
    """Subsystem 0's dt in `dtype`: a scalar, or one a lane [B] shaped
    [B, 1 x nd] to broadcast against tensors with `nd` more axes."""
    dt = funcs.base_spec(spec).dt.to(dtype)
    return dt.reshape(dt.shape + (1,) * nd) if dt.dim() else dt


def sparse_mu(spec: Spec, kp_idx: Sequence[int]):
    """Stacked keypoint targets over keypoint rows; a sequential spec
    interleaves its subsystems' blocks, zero where a subsystem has no
    keypoint (getMuVector(true), System.cpp:321-327)."""
    rows = []
    for k in kp_idx:
        if spec.kind == "sequential":
            rows.append(torch.cat([s.mu[k] * s.kp_mask[k] for s in spec.subs]))
        else:
            rows.append(spec.mu[k])
    return torch.cat(rows)


def sparse_Q(spec: Spec, kp_idx: Sequence[int]):
    """Block-diagonal keypoint precisions over keypoint rows
    [n_kp nQ, n_kp nQ] (getQMatrix(true), System.cpp:341-349)."""
    return torch.block_diag(*(funcs.prec_at(spec, k) for k in kp_idx)).to(
        spec.Rt.dtype)


def fast_supported(spec: Spec) -> bool:
    """True when the closed-form (Woodbury) body applies: a strictly
    positive control penalty, since the identity divides by R's diagonal.
    Every integrator kind qualifies."""
    return bool((spec.Rt > 0).all())


def _block_diag_lanes(Js):
    """[..., n, r, c] -> the block diagonal [..., n r, n c] of each lane."""
    *lead, n, r, c = Js.shape
    out = Js.new_zeros(*lead, n, r, n, c)
    for i in range(n):
        out[..., i, :, i, :] = Js[..., i, :, :]
    return out.reshape(*lead, n * r, n * c)


def _limits(spec: Spec, x, ks):
    """(L diagonal, violation q) [..., nx] at the states x [..., len(ks),
    nx] of the steps ks; zeros for a sequential spec (the top level sets no
    limits) and where no limits are set."""
    if spec.kind == "sequential" or not spec.limits_set:
        zero = torch.zeros_like(x)
        return zero, zero
    return funcs.limit_terms(spec, x, ks)


def _kp_rows(spec: Spec, fX_kp, X_prev, ks):
    """Residuals e [..., n_kp nQ] at the keypoint rows' forward maps
    fX_kp [..., n_kp, nt], and the lagged limit rows (ql, Lblk)
    [..., n_kp nx] at the previous states X_prev [..., n_kp, nx] (zero rows
    for a keypoint at step 0); ks [n_kp] the keypoint steps on the
    device."""
    e = funcs.residual(spec, fX_kp, ks)
    Ld, ql = _limits(spec, X_prev, ks)
    live = (ks != 0)[:, None]
    ql = torch.where(live, ql, 0.0)
    Ld = torch.where(live, Ld, 0.0)
    return e.flatten(-2), ql.flatten(-2), Ld.flatten(-2)


def _cost(Q, Rdiag, e, ql, Lblk, u):
    """e^T Q e + sum Rdiag u^2 + sum ql Lblk ql over the last axis."""
    return ((e * (e @ Q)).sum(-1) + (Rdiag * u * u).sum(-1)
            + (ql * Lblk * ql).sum(-1))


# ---------------------------------------------------------------------------
# the reference-shaped body
# ---------------------------------------------------------------------------

def _open_loop_rollout(spec: Spec, x0s, U):
    """fpBatch (System.cpp:181-211): the open-loop rollout of U [B, H-1, nu]
    from x0s [B, nx] -> X [B, H, nx], per-step (As, Bs) [B, H-1, ...] and the
    one-step-lagged limit arrays (Ldiag, qL) [B, H, nx]: slot i+1 holds the
    limit terms of x_i, slot 0 is zero."""
    H = spec.horizon
    X = x0s.new_empty((x0s.shape[0], H, spec.nx))
    As, Bs = [], []
    X[:, 0] = x = x0s
    for k in range(H - 1):
        x, A, Bk = funcs.dynamics(spec, x, U[:, k])
        X[:, k + 1] = x
        As.append(A)
        Bs.append(Bk)
    Ld, ql = _limits(spec, X[:, :-1], torch.arange(H - 1, device=X.device))
    zero = torch.zeros_like(X[:, :1])
    return (X, torch.stack(As, 1), torch.stack(Bs, 1),
            torch.cat([zero, Ld], 1), torch.cat([zero, ql], 1))


def _build_su(spec: Spec, As, Bs, kp_idx):
    """Su over keypoint rows [B, n_kp nx, (H-1) nu] with the reference's
    zero-seeded, pre-update capture: the keypoint at step i reads the
    matrix the update at i-1 produced ((As, Bs)[i-1] is the transition
    i-1 -> i)."""
    H, nx, nu = spec.horizon, spec.nx, spec.nu
    Bsz = As.shape[0]
    M = As.new_zeros((Bsz, nx, (H - 1) * nu))
    Su = As.new_zeros((Bsz, len(kp_idx), nx, (H - 1) * nu))
    for i in range(1, H):
        for j, k in enumerate(kp_idx):
            if k == i:
                Su[:, j] = M
        if i == max(kp_idx):
            break
        M = As[:, i - 1] @ M
        M[:, :, i * nu:(i + 1) * nu] = Bs[:, i - 1]
    return Su.reshape(Bsz, len(kp_idx) * nx, (H - 1) * nu)


def _solve_body(spec, Q, psi, x0s, u0s, kp_idx, nb_iter, early_stop,
                use_psi, callback=None):
    H, nu = spec.horizon, spec.nu
    Bsz = u0s.shape[0]
    dev = u0s.device
    Rdiag = _rdiag(spec, u0s.dtype)
    ks = torch.tensor(kp_idx, device=dev)

    def evaluate(u):
        X, As, Bs, Ldiag, qL = _open_loop_rollout(spec, x0s,
                                                  u.view(Bsz, H - 1, nu))
        fX_kp, J = funcs.fx_jac(spec, X[:, ks])
        e = funcs.residual(spec, fX_kp, ks)
        return (As, Bs, J, e.flatten(-2), qL[:, ks].flatten(-2),
                Ldiag[:, ks].flatten(-2))

    u = u0s
    it = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    cost0 = u0s.new_full((Bsz,), float("inf"))
    info = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    while True:
        active = (it < nb_iter) & ~done
        if not host_read(active.any()):
            break
        As, Bs, J, e, ql, Lblk = evaluate(u)
        Su = _build_su(spec, As, Bs, kp_idx)
        Jblk = _block_diag_lanes(J)                     # [B, n_kp nQ, n_kp nx]
        JQJ = _mT(Jblk) @ Q @ Jblk + torch.diag_embed(Lblk)
        lhs = _mT(Su) @ JQJ @ Su
        g = (_mT(Jblk) @ (Q @ e[..., None]))[..., 0] + Lblk * ql
        rhs = (_mT(Su) @ g[..., None])[..., 0] - Rdiag * u
        if use_psi:
            lhs = psi.T @ lhs @ psi + psi.T @ (Rdiag[..., :, None] * psi)
            dw, inf_ = torch.linalg.solve_ex(lhs, (psi.T @ rhs[..., None])[..., 0])
            du = (psi @ dw[..., None])[..., 0]
        else:
            du, inf_ = torch.linalg.solve_ex(lhs + torch.diag_embed(Rdiag), rhs)
        info = torch.where(active, inf_, info)
        c0 = _cost(Q, Rdiag, e, ql, Lblk, u)

        # the backtracking line search, per lane: alpha halves until the
        # trial's cost is below cost0 or alpha < 1e-3
        pending = active.clone()
        alpha = torch.ones_like(c0)
        u_new = u
        while host_read(pending.any()):
            utmp = u + alpha[:, None] * du
            _, _, _, et, qlt, Lt = evaluate(utmp)
            ok = (_cost(Q, Rdiag, et, qlt, Lt, utmp) < c0) | (alpha < 1e-3)
            u_new = torch.where(pending[:, None], utmp, u_new)
            alpha = torch.where(pending & ~ok, alpha / 2, alpha)
            pending = pending & ~ok
        if callback is not None:
            emit_progress(callback, active, it, c0, alpha)

        new_done = early_stop & (alpha * torch.sqrt((du * du).sum(-1)) < 1e-3)
        u = torch.where(active[:, None], u_new, u)
        cost0 = torch.where(active, c0, cost0)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, new_done, done)
    _check_info(info)
    return BatchResult(u=u, cost=cost0, iterations=it)


# ---------------------------------------------------------------------------
# closed forms: the reference's O(H^2) transfer-matrix loop and per-step
# rollout collapse to analytic formulas for the integrator dynamics
# ---------------------------------------------------------------------------

def _live(ks, H, lo, js=None):
    """(ks [n, 1], js [1, n_js], the [n, n_js] mask of lo <= j < k) for the
    row steps ks [n] (a tensor on the device) and the control steps js
    (all H-1 when None): lo = 0 gives the controls that reach x_k, lo = 1
    the columns 1..k-1 the reference's capture fills."""
    ks_a = ks[:, None]
    if js is None:
        js = torch.arange(H - 1, device=ks.device)
    js = js[None, :]
    return ks_a, js, (js >= lo) & (js < ks_a)


def _lti_su_rows(spec: Spec, ks, dtype, js=None):
    """Closed-form Su over keypoint rows [n_kp nx, n_js nu], shared by
    every lane ([B, n_kp nx, n_js nu] for a per-lane dt): the zero-seeded
    recursion leaves column 0 empty and the pre-update capture at keypoint
    k stores A^{k-1-j} B in column j for 1 <= j <= k-1. Single integrator:
    dt I; double integrator A^p B = [[(1/2 + p) dt^2 I], [dt I]] with
    p = k-1-j. js: the (global) control steps whose columns to emit, all
    H-1 when None; a sequence-parallel rank passes its own slice."""
    base = funcs.base_spec(spec)
    H, nx, nu, dof = spec.horizon, spec.nx, spec.nu, base.dof
    dev = ks.device
    dt = _dt(spec, dtype, 2)
    n_kp = ks.shape[0]
    ks, js, live = _live(ks, H, 1, js)
    if base.nb_deriv == 1:
        w = torch.where(live, dt, 0.0).to(dtype)
        blocks = w[..., None, None] * torch.eye(nu, dtype=dtype, device=dev)
    else:
        p = (ks - 1 - js).to(dtype)
        top = torch.where(live, (0.5 + p) * dt * dt, 0.0)
        bot = torch.where(live, dt, 0.0)
        eye = torch.eye(dof, dtype=dtype, device=dev)
        blocks = torch.cat([top[..., None, None] * eye,
                            bot[..., None, None] * eye], dim=-2)
    n_js = blocks.shape[-3]
    return blocks.transpose(-3, -2).reshape(
        blocks.shape[:-4] + (n_kp * nx, n_js * nu))


def _lti_states_partial(spec: Spec, U, ks, js=None):
    """The control part of the states at the rows ks [n] [..., n, nx] from the
    closed-form integrator solution, U [..., n_js, nu] the controls of the
    steps js (all H-1 when None; a sequence-parallel rank passes its slice
    and sums the partials over the ranks). Single integrator: dt sum_{j<k}
    u_j; double integrator: q part sum_{j<k} (1/2 + k-1-j) dt^2 u_j, dq part
    dt sum_{j<k} u_j. A per-lane dt needs U's lane axis first."""
    base = funcs.base_spec(spec)
    dtype = U.dtype
    dt = _dt(spec, dtype, 2)
    ks_a, js, live = _live(ks, spec.horizon, 0, js)
    live = live.to(dtype)
    if base.nb_deriv == 1:
        return dt * (live @ U)
    dq = dt * (live @ U)
    coef = live * (0.5 + (ks_a - 1 - js).to(dtype)) * dt * dt
    return torch.cat([coef @ U, dq], dim=-1)


def _lti_states_base(spec: Spec, x0s, ks):
    """The control-independent part of the states at the rows ks [n]
    [..., n, nx] from the initial states x0s [..., nx]."""
    base = funcs.base_spec(spec)
    if base.nb_deriv == 1:
        return x0s[..., None, :].expand(*x0s.shape[:-1], ks.shape[0], spec.nx)
    dt = _dt(spec, x0s.dtype, 2)
    dof = base.dof
    ks_a = ks[:, None].to(x0s.dtype)
    q0, dq0 = x0s[..., None, :dof], x0s[..., None, dof:]
    q = q0 + ks_a * dt * dq0
    return torch.cat([q, dq0.expand(q.shape)], dim=-1)


def _lti_states_at(spec: Spec, x0s, U, ks):
    """States at the rows ks [n]: base + full control sum."""
    return _lti_states_base(spec, x0s, ks) + _lti_states_partial(spec, U, ks)


def _shift(a):
    """a_col[..., j, :] = a[..., j-1, :] (column j carries step j-1's
    quantity), zero at j = 0; `a` has its step axis second to last."""
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]], dim=-2)


def _time_su_rows(spec: Spec, ks, U, x0s):
    """Closed-form Su over keypoint rows [B, n_kp nx, (H-1) nu] for the
    time-optimal kinds from U [B, H-1, nu], reproducing the zero-seeded
    pre-update capture with the rollout's B_j: Su[k][:, j] = A_{k-1} ...
    A_{j+1} B_{j-1} for 1 <= j <= k-1.

    First order: A = I, so the block is B_{j-1} with B_i[:dof, :dof] =
    dt_i I, B_i[:dof, -1] = 2 s_i u_i[:dof], B_i[-1, -1] = 2 s_i. Second
    order: A_i = I + dt_i E with E^2 = 0, so the block is
    (I + (T_{k-1} - T_j) E) B_{j-1}; B_i's last column uses the *updated*
    velocity dq_{i+1}."""
    base = funcs.base_spec(spec)
    H, nx, nu, dof = spec.horizon, spec.nx, spec.nu, base.dof
    dtype, dev = U.dtype, U.device
    Bsz, n_kp = U.shape[0], ks.shape[0]
    s_raw = U[..., -1]                                   # [B, H-1]
    dt_raw = s_raw * s_raw
    s = _shift(s_raw[..., None])[..., 0]                 # s[j] = s_{j-1}
    dt = s * s
    Ucol = _shift(U)                                     # u_{j-1} at column j
    ks, js, live = _live(ks, H, 1)
    live = live.to(dtype)                                # [n_kp, H-1]

    blocks = U.new_zeros((Bsz, n_kp, H - 1, nx, nu))
    eye = torch.eye(dof, dtype=dtype, device=dev)
    live_b = live[None]                                  # [1, n_kp, H-1]
    two_s = 2.0 * s[:, None, :]                          # [B, 1, H-1]
    if base.nb_deriv == 1:
        blocks[..., :dof, :dof] = (live_b * dt[:, None, :])[..., None, None] * eye
        blocks[..., :dof, -1] = live_b[..., None] * (
            two_s[..., None] * Ucol[:, None, :, :dof])
        blocks[..., -1, -1] = live_b * two_s
    else:
        ddq = Ucol[..., :dof]                            # ddq_{j-1} at column j
        T = torch.cat([U.new_zeros((Bsz, 1)), torch.cumsum(dt_raw, -1)], -1)
        dq0 = x0s[:, dof:2 * dof]
        # dq after step i (= dq_{i+1}); column j needs dq_j = dq_next[j-1]
        dq_next = dq0[:, None, :] + torch.cumsum(dt_raw[..., None] * U[..., :dof], -2)
        dq_col = _shift(dq_next)
        P = T[:, (ks - 1).expand(n_kp, H - 1)] - T[:, js.expand(n_kp, H - 1)]
        blocks[..., :dof, :dof] = (live_b * ((0.5 * dt * dt)[:, None, :]
                                             + P * dt[:, None, :])
                                   )[..., None, None] * eye
        blocks[..., dof:2 * dof, :dof] = (live_b * dt[:, None, :])[..., None, None] * eye
        s3 = (s ** 3)[:, None, :, None]
        last_q = (two_s[..., None] * dq_col[:, None]
                  + 2.0 * s3 * ddq[:, None]
                  + P[..., None] * two_s[..., None] * ddq[:, None])
        blocks[..., :dof, -1] = live_b[..., None] * last_q
        blocks[..., dof:2 * dof, -1] = live_b[..., None] * (
            two_s[..., None] * ddq[:, None])
        blocks[..., -1, -1] = live_b * two_s
    return blocks.permute(0, 1, 3, 2, 4).reshape(Bsz, n_kp * nx, (H - 1) * nu)


def _time_states_at(spec: Spec, x0s, U, ks):
    """States at the rows ks [n] [..., n, nx] for the time-optimal dynamics
    from U [..., H-1, nu], closed form: t_k = t0 + T_k; first order q_k =
    q0 + sum_{j<k} dt_j u_j[:dof]; second order dq_k = dq0 + sum dt_j ddq_j
    and q_k = q0 + T_k dq0 + sum_{j<k} (dt_j (T_k - T_{j+1}) + dt_j^2/2)
    ddq_j."""
    base = funcs.base_spec(spec)
    dtype = U.dtype
    dof = base.dof
    s = U[..., -1]
    dt = s * s
    T = torch.cat([torch.zeros_like(dt[..., :1]), torch.cumsum(dt, -1)], -1)
    ks_a, js, live = _live(ks, spec.horizon, 0)
    live = live.to(dtype)
    Tk = T[..., ks]                                      # [..., n]
    t = x0s[..., -1:] + Tk
    wdt = live * dt[..., None, :]                        # [..., n, H-1]
    if base.nb_deriv == 1:
        q = x0s[..., None, :dof] + wdt @ U[..., :dof]
        return torch.cat([q, t[..., None]], dim=-1)
    q0, dq0 = x0s[..., None, :dof], x0s[..., None, dof:2 * dof]
    ddq = U[..., :dof]
    dq = dq0 + wdt @ ddq
    n = ks.shape[0]
    Hm1 = spec.horizon - 1
    rem = T[..., ks_a.expand(n, Hm1)] - T[..., (js + 1).expand(n, Hm1)]
    coef = live * (dt[..., None, :] * rem + 0.5 * dt[..., None, :] * dt[..., None, :])
    q = q0 + Tk[..., None] * dq0 + coef @ ddq
    return torch.cat([q, dq, t[..., None]], dim=-1)


def _stable_gn_du(Su, Qh, Jblk, Lblk, Rd, rhs):
    """du = (diag(Rd) + Su^T (Jblk^T Q Jblk + diag(Lblk)) Su)^{-1} rhs by
    the symmetric square-root (dual least-squares) identity: with
    V = [Qh Jblk Su; sqrt(Lblk) Su] diag(Rd)^{-1/2} and Q = Qh^T Qh,

        du = diag(Rd)^{-1/2} (r' - V^T (I_q + V V^T)^{-1} V r'),
        r' = diag(Rd)^{-1/2} rhs,

    a q x q SPD solve (q = residual rows + limit rows) in place of the
    dense [(H-1) nu]^2 system. The asymmetric push-through form
    (I + Su D^{-1} Su^T M)^{-1} diverges in reduced precision (1/Rd enters
    twice and the inner matrix is non-normal); this form keeps the
    ill-conditioning inside one SPD solve. -> (du [B, W], info [B])"""
    sR = torch.sqrt(Rd)
    V = torch.cat([Qh @ (Jblk @ Su), torch.sqrt(Lblk)[..., None] * Su],
                  dim=-2) / sR[..., None, :]
    rp = rhs / sR
    G = torch.eye(V.shape[-2], dtype=V.dtype, device=V.device) + V @ _mT(V)
    y, info = torch.linalg.solve_ex(G, (V @ rp[..., None])[..., 0])
    return (rp - (_mT(V) @ y[..., None])[..., 0]) / sR, info


def _solve_body_fast(spec, Q, psi, x0s, u0s, kp_idx, nb_iter, early_stop,
                     use_psi):
    """Scan-free batch solve with the numerics of _solve_body: states and
    Su in closed form, FK at keypoint rows only, the Gauss-Newton step by
    `_stable_gn_du` (plain) or the projected K nu system (CP), the line
    search as all 11 trials alpha = 1, 1/2, ..., 2^-10 at once (the first
    with cost < cost0 wins; the 2^-10 trial is the reference's
    unconditional alpha < 1e-3 floor), and `nb_iter` masked iterations
    with early-stopped lanes frozen."""
    H, nu = spec.horizon, spec.nu
    Bsz = u0s.shape[0]
    dtype, dev = u0s.dtype, u0s.device
    time_opt = funcs.base_spec(spec).time_optimal
    Rdiag = _rdiag(spec, dtype)
    # the keypoint rows and the rows before them, on the device once
    ks = torch.tensor(kp_idx, device=dev)
    ks_prev = (ks - 1).clamp(min=0)
    # LTI kinds: Su is the same for every lane, and so is (Su psi), unless
    # dt is one a lane
    Su_const = None if time_opt else _lti_su_rows(spec, ks, dtype)
    alphas = 2.0 ** -torch.arange(0, 11, dtype=dtype, device=dev)
    if use_psi:
        psiRpsi = psi.T @ (Rdiag[..., :, None] * psi)
        SuPsi = None if time_opt else Su_const @ psi
    else:
        # the square-root factor of the (constant, PSD) keypoint precision:
        # Q = Qh^T Qh, eigenvalues clipped at zero; once a solve
        wq, Uq = torch.linalg.eigh(Q)
        Qh = torch.sqrt(torch.clamp(wq, min=0.0))[:, None] * Uq.T

    def states(U, ks):
        if time_opt:
            return _time_states_at(spec, x0s, U, ks)
        return _lti_states_at(spec, x0s, U, ks)

    u = u0s
    it = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    cost_l = u0s.new_full((Bsz,), float("inf"))
    info = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    for _ in range(nb_iter):
        U2 = u.view(Bsz, H - 1, nu)
        Su = _time_su_rows(spec, ks, U2, x0s) if time_opt else Su_const
        Xk_u, Xp_u = states(U2, ks), states(U2, ks_prev)
        fX_kp, J = funcs.fx_jac(spec, Xk_u)
        e, ql, Lblk = _kp_rows(spec, fX_kp, Xp_u, ks)
        Jblk = _block_diag_lanes(J)
        g = (_mT(Jblk) @ (Q @ e[..., None]))[..., 0] + Lblk * ql
        rhs = (g[..., None, :] @ Su)[..., 0, :] - Rdiag * u
        if use_psi:
            M = _mT(Jblk) @ Q @ Jblk + torch.diag_embed(Lblk)
            G = Su @ psi if time_opt else SuPsi
            lhs = _mT(G) @ (M @ G) + psiRpsi
            dw, inf_ = torch.linalg.solve_ex(lhs, rhs @ psi)
            du = dw @ psi.T
        else:
            du, inf_ = _stable_gn_du(Su, Qh, Jblk, Lblk, Rdiag, rhs)
        info = torch.where(done, info, inf_)
        cost0 = _cost(Q, Rdiag, e, ql, Lblk, u)

        # all 11 trial costs at once, on a leading trial axis
        a = alphas[:, None]
        if time_opt:
            ut = u + a[..., None] * du                    # [11, B, W]
            Ut = ut.view(11, Bsz, H - 1, nu)
            e2, ql2, L2 = _kp_rows(spec, funcs.fx(spec, states(Ut, ks)),
                                   states(Ut, ks_prev), ks)
            costs = _cost(Q, Rdiag, e2, ql2, L2, ut)
        else:
            # LTI: keypoint-row states are linear in u, so a trial's are
            # the accepted states plus alpha times du's
            dU2 = du.view(Bsz, H - 1, nu)
            Xk_d = _lti_states_partial(spec, dU2, ks)
            Xp_d = _lti_states_partial(spec, dU2, ks_prev)
            ra = (Rdiag * u * u).sum(-1)
            rb = (Rdiag * u * du).sum(-1)
            rc = (Rdiag * du * du).sum(-1)
            a4 = a[..., None, None]
            e2, ql2, L2 = _kp_rows(spec, funcs.fx(spec, Xk_u + a4 * Xk_d),
                                   Xp_u + a4 * Xp_d, ks)
            costs = ((e2 * (e2 @ Q)).sum(-1) + (ra + 2.0 * a * rb + (a * a) * rc)
                     + (ql2 * L2 * ql2).sum(-1))
        ok = (costs < cost0) | (alphas < 1e-3)[:, None]  # [11, B]
        any_ok = ok.any(0)
        alpha = torch.where(any_ok, alphas[torch.argmax(ok.to(torch.int32), 0)],
                            1.0)
        u_new = torch.where(any_ok[:, None], u + alpha[:, None] * du, u)
        new_done = done | (early_stop
                           & (alpha * torch.sqrt((du * du).sum(-1)) < 1e-3))
        u = torch.where(done[:, None], u, u_new)
        it = torch.where(done, it, it + 1)
        cost_l = torch.where(done, cost_l, cost0)
        done = new_done
    _check_info(info)
    return BatchResult(u=u, cost=cost_l, iterations=it)


def _check_info(info):
    """Raise where a lane's linear solve met an exactly singular matrix
    (torch.linalg.solve_ex's info, read once a solve)."""
    bad = torch.nonzero(info).flatten()
    if bad.numel():
        raise torch.linalg.LinAlgError(
            f"the Gauss-Newton system is singular on lanes {bad.tolist()}")


def _solve_impl(spec: Spec, Q, psi, x0s, u0s, kp_idx, nb_iter: int,
                early_stop: bool, use_psi: bool, fast: bool,
                callback=None) -> BatchResult:
    """The batched solve on the spec's device: x0s [B, nx], u0s
    [B, (H-1) nu], Q the sparse keypoint precision, psi [(H-1) nu, K nu]
    when use_psi (else unused). `fast` runs the closed-form body (it needs
    every Rt > 0) unless a `callback` is given, else the reference-shaped
    one, which notifies the callback of lane 0's iterations."""
    args = (spec, Q, psi, x0s, u0s, tuple(int(k) for k in kp_idx),
            int(nb_iter), bool(early_stop), bool(use_psi))
    if fast and callback is None:
        return _solve_body_fast(*args)
    return _solve_body(*args, callback=callback)


def _single(spec: Spec, Q, psi, kp_idx, nb_iter, u0, early_stop, callback):
    kp_idx = tuple(int(k) for k in kp_idx)
    Q = sparse_Q(spec, kp_idx) if Q is None else torch.as_tensor(
        Q, dtype=spec.dtype, device=spec.device)
    u0 = torch.as_tensor(u0, dtype=spec.dtype, device=spec.device).reshape(1, -1)
    if psi is not None:
        psi = torch.as_tensor(psi, dtype=spec.dtype, device=spec.device)
    res = _solve_impl(spec, Q, psi, spec.x0[None], u0, kp_idx, nb_iter,
                      early_stop, psi is not None, fast_supported(spec),
                      callback)
    return BatchResult(u=res.u[0], cost=res.cost[0],
                       iterations=res.iterations[0])


def solve(spec: Spec, kp_idx: Sequence[int], nb_iter: int, u0,
          early_stop: bool = True, callback: Optional[object] = None,
          Q=None) -> BatchResult:
    """BatchILQR::solve(nb_iter, u0, early_stop) on the spec's device (CUDA
    unless the spec was built with device="cpu").

    kp_idx: keypoint timesteps in sorted order. u0: the flattened
    [(H-1) nu] initial controls. Q optionally overrides the sparse
    block-diagonal precision. `callback.notify(msg)` is called after each
    iteration ("Iteration i, Cost: c, alpha= a", the cost before the step);
    a solve with a callback runs the reference-shaped body.
    """
    return _single(spec, Q, None, kp_idx, nb_iter, u0, early_stop, callback)


def solve_cp(spec: Spec, psi, kp_idx: Sequence[int], nb_iter: int, u0,
             early_stop: bool = True, callback: Optional[object] = None,
             Q=None) -> BatchResult:
    """BatchILQRCP::solve: Gauss-Newton in the primitive weight space
    u = Psi w, psi [(H-1) nu, K nu]; otherwise as `solve`."""
    return _single(spec, Q, psi, kp_idx, nb_iter, u0, early_stop, callback)
