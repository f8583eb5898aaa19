"""System functions: forward map, residuals, dynamics, costs.

PyTorch counterpart of the JAX package's `systems/funcs.py`. Where the JAX
functions take one sample and are batched with vmap, these take tensors with
any leading batch axes and the small dimensions trailing (a state is
[..., nx]); a step index `k` is an int, or an integer tensor that broadcasts
against the leading axes (for a trajectory [B, H, nx], `torch.arange(H)`).

Quirks of the reference that the results depend on:
  * The control penalty u'Ru enters the cost *value* only at keypoint steps,
    while the cost gradient and Hessian use R at every step.
  * The joint-limit penalty L is a 0/1 diagonal scaled by `penalty`, and the
    quadratic term in l_xx is L^T L = penalty^2.
  * The final cost is the stage cost at step H-1 with u = 0.
  * The zero-state guard of the position + orientation residual covers its
    own rows only, not the time row of the time-optimal kind.
  * The time-optimal double integrator's last column of B reads the
    *updated* joint velocity.

A sequential spec concatenates its subsystems' forward maps, Jacobian rows
and residuals, takes a block-diagonal precision, sums the subsystems' limit
and control-penalty costs, and follows subsystem 0's dynamics.

Per-scenario leaves: `mu`, `prec`, `pos_radius`, `orn_thresh`, `kp_mask`,
`Rt`, `state_min`, `state_max`, `limit_weight`, `penalty` and `dt` may carry
one more LEADING axis, the scenario batch B (the spec of
`parallel.mesh.batch_specs`); the states then carry B as their first axis
too (or right after leading trial axes), and the step index broadcasts
against the axes after it. A per-lane `dt` needs the states' lane axis
first.
"""

import torch

from ilqr_planner_torch.models.robot import robot_fk, robot_kin
from ilqr_planner_torch.ops import sd
from ilqr_planner_torch.systems.spec import Spec

__all__ = [
    "fx",
    "fx_jac",
    "residual",
    "prec_at",
    "dynamics",
    "constant_AB",
    "stage_cost",
    "final_cost",
    "cost_gradients",
    "limit_terms",
    "ctrl_cost",
]


# the dimensions of each per-scenario leaf without a scenario axis
_LEAF_DIMS = {"mu": 2, "prec": 3, "kp_mask": 1, "pos_radius": 1,
              "orn_thresh": 2, "Rt": 1, "state_min": 1, "state_max": 1,
              "limit_weight": 1, "penalty": 0, "dt": 0}


def lane_leaf(spec: Spec, name: str) -> bool:
    """True when leaf `name` carries a leading scenario axis."""
    return getattr(spec, name).dim() > _LEAF_DIMS[name]


def _at(spec: Spec, name: str, k):
    """Leaf `name` at step k; a leaf with a leading scenario axis keeps it
    in front ([B, ...] at an int k, [B, len(k), ...] at a step tensor)."""
    leaf = getattr(spec, name)
    if leaf.dim() > _LEAF_DIMS[name]:
        return leaf[:, k]
    return leaf[k]


def _lane(spec: Spec, name: str, k=None):
    """Leaf `name` shaped to broadcast against stage tensors at step k: a
    leaf with a leading scenario axis gets a step axis after it where k is
    a step tensor, and a scalar leaf per lane a trailing axis ([B, 1] at an
    int k, [B, 1, 1] at a step tensor); a shared leaf is returned as is."""
    leaf = getattr(spec, name)
    if leaf.dim() == _LEAF_DIMS[name]:
        return leaf
    if torch.is_tensor(k) and k.dim():
        leaf = leaf[:, None]
    return leaf[..., None] if _LEAF_DIMS[name] == 0 else leaf


def base_spec(spec: Spec) -> Spec:
    """The spec whose dynamics (and dt) a solve follows: subsystem 0 of a
    sequential spec, else the spec itself."""
    return spec.subs[0] if spec.kind == "sequential" else spec


def _subs_of(spec: Spec):
    if not spec.subs:
        raise ValueError("a sequential spec needs at least one subsystem")
    return spec.subs


def _mv(A, v):
    """A [..., i, j] @ v [..., j] -> [..., i]."""
    return (A * v[..., None, :]).sum(-1)


# --------------------------------------------------------------------------
# state unpacking
# --------------------------------------------------------------------------

def _unpack(spec: Spec, x):
    """x -> (q, dq, t). dq is zero for first-order states; t is None unless
    the kind is time-optimal."""
    dof = spec.dof
    q = x[..., :dof]
    dq = x[..., dof:2 * dof] if spec.nb_deriv == 2 else torch.zeros_like(q)
    t = x[..., -1] if spec.time_optimal else None
    return q, dq, t


# --------------------------------------------------------------------------
# forward map f(x) and its Jacobian J [nQ, nx]
# --------------------------------------------------------------------------

def fx_jac(spec: Spec, x):
    """(f(x) [..., nt], J [..., nQ, nx]) at the states x [..., nx].

    J pairs the residual rows with state columns: geometric Jacobian rows
    for the task-space kinds, the identity for joint space, and a unit
    row/column for the time axis.
    """
    if spec.kind == "sequential":
        parts = [fx_jac(sub, x) for sub in _subs_of(spec)]
        batch = torch.broadcast_shapes(*(J.shape[:-2] for _, J in parts))
        return (torch.cat([f for f, _ in parts], dim=-1),
                torch.cat([J.expand(*batch, *J.shape[-2:]) for _, J in parts],
                          dim=-2))
    dof, nx = spec.dof, spec.nx
    batch = x.shape[:-1]

    if spec.kind in ("joint", "joint_time"):
        J = torch.eye(spec.nq_var, nx, dtype=x.dtype, device=x.device)
        return x, J.expand(*batch, spec.nq_var, nx)

    q, dq, t = _unpack(spec, x)
    ks = robot_kin(spec.robot, q, dq, with_dJ=False)

    if spec.kind == "point":
        c = spec.robot.nb_car_dim
        Jt = ks.J[..., :c, :]
        if spec.nb_deriv == 1:
            return ks.x, Jt
        J = x.new_zeros(*batch, 2 * c, nx)
        J[..., :c, :dof] = Jt
        J[..., c:, dof:] = Jt
        return torch.cat([ks.x, ks.dx], dim=-1), J

    # posorn / posorn_time
    J6 = ks.J
    if spec.nb_deriv == 1:
        fx = torch.cat([ks.x, ks.quat], dim=-1)
        Jcore, core_rows = J6, 6
    else:
        dquat = sd.quat_rate(ks.quat, ks.w)
        fx = torch.cat([ks.x, ks.quat, ks.dx, dquat], dim=-1)
        core_rows = 12
        Jcore = x.new_zeros(*batch, 12, 2 * dof)
        Jcore[..., :6, :dof] = J6
        Jcore[..., 6:, dof:] = J6

    if spec.kind == "posorn":
        return fx, Jcore

    # posorn_time: append the time component (row/column of 1)
    fx = torch.cat([fx, t[..., None]], dim=-1)
    J = x.new_zeros(*batch, core_rows + 1, nx)
    J[..., :core_rows, :Jcore.shape[-1]] = Jcore
    J[..., core_rows, nx - 1] = 1.0
    return fx, J


def fx(spec: Spec, x):
    """f(x) [..., nt] alone, equal bit for bit to `fx_jac(spec, x)[0]`: what
    a line-search trial needs. The first-order task-space kinds walk the
    chain without forming the Jacobian; a second-order forward map holds
    velocities J dq, so it goes through `fx_jac`."""
    if spec.kind == "sequential":
        return torch.cat([fx(sub, x) for sub in _subs_of(spec)], dim=-1)
    if spec.nb_deriv == 2 or spec.kind in ("joint", "joint_time"):
        return fx_jac(spec, x)[0]
    q, _, t = _unpack(spec, x)
    pos, quat = robot_fk(spec.robot, q)
    if spec.kind == "point":
        return pos
    f = torch.cat([pos, quat], dim=-1)
    if spec.kind == "posorn":
        return f
    return torch.cat([f, t[..., None]], dim=-1)


# --------------------------------------------------------------------------
# keypoint residuals
# --------------------------------------------------------------------------

def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _posorn_residual(spec: Spec, fx, k):
    """Position + orientation residual r_p = p* - p, r_o = -2 E(q*)
    logMap(q*, q), with the dead-zone shrinkage applied through the per-step
    radius/threshold arrays (zero radius/threshold: a plain keypoint);
    second order appends dp* - dp and -2 E(q*)(dq* - transport(dq, q -> q*)).
    """
    c = spec.robot.nb_car_dim
    mu_k = _at(spec, "mu", k)
    p_t, q_t = mu_k[..., :c], mu_k[..., c:c + 4]
    p, quat = fx[..., :c], fx[..., c:c + 4]
    E = sd.dquat_to_dx_jac(q_t)
    r_p = p_t - p
    r_o = -2.0 * _mv(E, sd.log_map(q_t, quat))

    # Dead zones, on the position/orientation residuals only (not the
    # velocity parts).
    radius = _at(spec, "pos_radius", k)
    nrm = torch.sqrt((r_p * r_p).sum(-1))
    shrunk = _safe_div(r_p, nrm[..., None]) * (nrm - radius)[..., None]
    r_p = torch.where((nrm <= radius)[..., None], torch.zeros_like(r_p), shrunk)
    th = _at(spec, "orn_thresh", k)
    r_o = torch.where(r_o.abs() <= th, torch.zeros_like(r_o),
                      r_o - torch.sign(r_o) * th)

    parts = [r_p, r_o]
    if spec.nb_deriv == 2:
        dp_t, dq_t = mu_k[..., c + 4:2 * c + 4], mu_k[..., 2 * c + 4:2 * c + 8]
        dp, dquat = fx[..., c + 4:2 * c + 4], fx[..., 2 * c + 4:2 * c + 8]
        parts += [dp_t - dp,
                  -2.0 * _mv(E, dq_t - sd.transport(dquat, quat, q_t))]
    return torch.cat(parts, dim=-1)


def residual(spec: Spec, fx, k):
    """Keypoint residual e(f(x), k) [..., nQ]; zero when step k has no
    keypoint, or (position + orientation rows only) when the forward map is
    exactly zero."""
    if spec.kind == "sequential":
        es, off = [], 0
        for sub in _subs_of(spec):
            es.append(residual(sub, fx[..., off:off + sub.nt], k))
            off += sub.nt
        return torch.cat(es, dim=-1)
    if spec.kind.startswith("posorn"):
        fx_po = fx[..., :spec.nt - 1] if spec.time_optimal else fx
        core = _posorn_residual(spec, fx_po, k)
        zero_state = (fx_po == 0).all(-1)
        core = torch.where(zero_state[..., None], torch.zeros_like(core), core)
        if spec.time_optimal:
            # the time row is appended unguarded
            r_t = _at(spec, "mu", k)[..., -1] - fx[..., -1]
            core = torch.cat([core, r_t[..., None]], dim=-1)
        e = core
    else:  # joint / joint_time / point: plain unguarded Euclidean residual
        e = _at(spec, "mu", k) - fx
    return e * _at(spec, "kp_mask", k)[..., None]


def prec_at(spec: Spec, k):
    """Precision [..., nQ, nQ] at step k; block-diagonal over the
    subsystems of a sequential spec."""
    if spec.kind != "sequential":
        return _at(spec, "prec", k)
    blocks = [prec_at(sub, k) for sub in _subs_of(spec)]
    batch = torch.broadcast_shapes(*(b.shape[:-2] for b in blocks))
    n = spec.nq_var
    P = blocks[0].new_zeros(*batch, n, n)
    off = 0
    for b in blocks:
        w = b.shape[-1]
        P[..., off:off + w, off:off + w] = b
        off += w
    return P


# --------------------------------------------------------------------------
# joint limits
# --------------------------------------------------------------------------

def limit_terms(spec: Spec, x, k=None):
    """(L diagonal, violation q), each [..., nx]: L entries equal `penalty`
    where the (weighted) state exceeds its bounds; q = bound - x there,
    else zero. k: the states' step index (an int or a step tensor), which
    places per-lane limit leaves."""
    smax, smin = _lane(spec, "state_max", k), _lane(spec, "state_min", k)
    over = x > smax
    under = x < smin
    active = (_lane(spec, "limit_weight", k) != 0) & (over | under)
    zero = torch.zeros_like(x)
    Ld = torch.where(active, _lane(spec, "penalty", k).to(x.dtype), zero)
    ql = torch.where(over, smax - x, torch.where(under, smin - x, zero))
    return Ld, torch.where(active, ql, zero)


def _limit_triplet(spec: Spec, x, k=None):
    """(cost [...], L^T q [..., nx], diag(L^T L) [..., nx]), summed over
    the subsystems of a sequential spec; k as in `limit_terms`."""
    if spec.kind == "sequential":
        zero = torch.zeros_like(x)
        cost, Lq, L2 = zero.sum(-1), zero, zero
        for sub in _subs_of(spec):
            c_s, Lq_s, L2_s = _limit_triplet(sub, x, k)
            cost, Lq, L2 = cost + c_s, Lq + Lq_s, L2 + L2_s
        return cost, Lq, L2
    if not spec.limits_set:
        zero = torch.zeros_like(x)
        return zero.sum(-1), zero, zero
    Ld, ql = limit_terms(spec, x, k)
    return (Ld * ql * ql).sum(-1), Ld * ql, Ld * Ld


def ctrl_cost(spec: Spec, u, k):
    """Control penalty as counted in the cost *value*: u^T R u only where
    step k has a keypoint; each subsystem of a sequential spec adds its own
    at its own keypoints."""
    if spec.kind == "sequential":
        return sum(ctrl_cost(sub, u, k) for sub in _subs_of(spec))
    return _at(spec, "kp_mask", k) * (_lane(spec, "Rt", k) * u * u).sum(-1)


# --------------------------------------------------------------------------
# stage / terminal cost
# --------------------------------------------------------------------------

def stage_cost(spec: Spec, x, fx, u, k):
    """cost(x, u, k) = e^T P e + [kp] u^T R u + q_L^T L q_L."""
    e = residual(spec, fx, k)
    c = (e * _mv(prec_at(spec, k), e)).sum(-1) + ctrl_cost(spec, u, k)
    lim_c, _, _ = _limit_triplet(spec, x, k)
    return c + lim_c


def final_cost(spec: Spec, x, fx):
    """cost_F = the stage cost at k = horizon-1 with u = 0."""
    u0 = x.new_zeros(*x.shape[:-1], spec.nu)
    return stage_cost(spec, x, fx, u0, spec.horizon - 1)


def cost_gradients(spec: Spec, x, fx, J, u, k):
    """(l_x, l_u, l_xx) of the Gauss-Newton quadratization:
    l_x = -J^T P e - L^T q, l_xx = J^T P J + L^T L, l_u = R u (the
    top-level R of a sequential spec)."""
    e = residual(spec, fx, k)
    P = prec_at(spec, k)
    _, Lq, L2 = _limit_triplet(spec, x, k)
    Jt = J.transpose(-1, -2)
    l_x = -_mv(Jt, _mv(P, e)) - Lq
    l_xx = Jt @ P @ J + torch.diag_embed(L2)
    l_u = _lane(spec, "Rt", k) * u
    return l_x, l_u, l_xx


# --------------------------------------------------------------------------
# dynamics
# --------------------------------------------------------------------------

def constant_AB(spec: Spec, dtype):
    """(A [nx, nx], B [nx, nu]) for the state-independent integrators, or
    None for the time-optimal kinds, whose B depends on (x, u). A per-lane
    dt [B] gives B [B, nx, nu] (and A [B, nx, nx] for the double
    integrator). A sequential spec follows subsystem 0."""
    if spec.kind == "sequential":
        return constant_AB(_subs_of(spec)[0], dtype)
    if spec.time_optimal:
        return None
    dof, nx, nu = spec.dof, spec.nx, spec.nu
    dev = spec.device
    dt = spec.dt.to(dtype)
    lead = tuple(dt.shape)
    dt = dt.reshape(lead + (1,) * (2 if lead else 0))
    eye = torch.eye(dof, dtype=dtype, device=dev)
    if spec.nb_deriv == 1:
        return (torch.eye(nx, dtype=dtype, device=dev),
                dt * torch.eye(nx, nu, dtype=dtype, device=dev))
    A = torch.eye(nx, dtype=dtype, device=dev).repeat(lead + (1, 1))
    A[..., :dof, dof:] = dt * eye
    B = torch.cat([0.5 * dt * dt * eye, dt * eye], dim=-2)
    return A, B


def _next_state(spec: Spec, x, u):
    """One integrator step x' [..., nx] (the state part of `dynamics`)."""
    if spec.kind == "sequential":
        return _next_state(_subs_of(spec)[0], x, u)
    dof = spec.dof
    if not spec.time_optimal:
        dt = spec.dt.to(x.dtype)
        if dt.dim():                 # one a lane, the lanes x's first axis
            dt = dt.reshape(dt.shape + (1,) * (x.dim() - 1))
        if spec.nb_deriv == 1:
            return x + dt * u
        q, dq = x[..., :dof], x[..., dof:]
        return torch.cat([q + dt * dq + 0.5 * dt * dt * u, dq + dt * u], dim=-1)
    s = u[..., -1:]
    dt = s * s
    t = x[..., -1:]
    cmd = u[..., :-1]
    if spec.nb_deriv == 1:
        return torch.cat([x[..., :dof] + dt * cmd, t + dt], dim=-1)
    q, dq = x[..., :dof], x[..., dof:2 * dof]
    return torch.cat([q + dt * dq + 0.5 * dt * dt * cmd, dq + dt * cmd, t + dt],
                     dim=-1)


def dynamics(spec: Spec, x, u):
    """One integrator step: (x' [..., nx], A [..., nx, nx], B [..., nx, nu]).

    Velocity control (nb_deriv=1): q' = q + dt u; A = I, B = dt I.
    Acceleration control (nb_deriv=2): semi-implicit Euler q' = q + dt dq +
    dt^2/2 u, dq' = dq + dt u; A = [[I, dt I], [0, I]], B = [[dt^2/2 I],
    [dt I]]. The time-optimal kinds use dt = s^2 with s = u[-1] and the
    chain-rule last column of B. A sequential spec follows subsystem 0.
    """
    if spec.kind == "sequential":
        return dynamics(_subs_of(spec)[0], x, u)
    dof, nx, nu = spec.dof, spec.nx, spec.nu
    batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    xn = _next_state(spec, x, u)

    if not spec.time_optimal:
        A, B = constant_AB(spec, x.dtype)
        return xn, A.expand(*batch, nx, nx), B.expand(*batch, nx, nu)

    # time-optimal: s = sqrt(dt) is the last control component
    eye = torch.eye(dof, dtype=x.dtype, device=x.device)
    s = u[..., -1]
    dt = (s * s)[..., None, None]
    cmd = u[..., :-1]
    A = torch.eye(nx, dtype=x.dtype, device=x.device).repeat(*batch, 1, 1)
    B = x.new_zeros(*batch, nx, nu)
    if spec.nb_deriv == 1:
        B[..., :dof, :dof] = dt * eye
        B[..., :dof, -1] = 2.0 * s[..., None] * cmd
        B[..., -1, -1] = 2.0 * s
        return xn, A, B
    A[..., :dof, dof:2 * dof] = dt * eye
    B[..., :dof, :dof] = 0.5 * dt * dt * eye
    B[..., dof:2 * dof, :dof] = dt * eye
    dqn = xn[..., dof:2 * dof]       # the UPDATED velocity
    B[..., :dof, -1] = 2.0 * s[..., None] * dqn + 2.0 * (s ** 3)[..., None] * cmd
    B[..., dof:2 * dof, -1] = 2.0 * s[..., None] * cmd
    B[..., -1, -1] = 2.0 * s
    return xn, A, B
