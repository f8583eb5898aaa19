"""Lane-major (struct-of-arrays) fleet solver.

PyTorch counterpart of the JAX package's `solvers/fleet.py`. The scenario
batch B is the TRAILING axis of every tensor, so on the card thread b reads
address b. Small matrices are [3, 3, B] / [n, n, B] tensors; products over
them broadcast and reduce over the inner axis (`_mm`, `_mv`) instead of the
JAX package's trace-time lists of [B] vectors. Multiplying or adding the
exact zeros and ones that the JAX lists folded away leaves every value as it
was, so the only numerical difference is the order of the sums (~1 ulp).

Per iteration: the backward sweep (`_backward`), then the line search over
alpha = 1, 1/2, ..., 2^-10 with early exit once every lane has accepted.
The sweep runs in a whole-sweep CUDA kernel on the card (its plain twin on
the CPU) wherever the JAX package runs a Pallas kernel:
`ops/cuda_kernels/segment_backward.py` for first order,
`ops/cuda_kernels/segment_backward_2nd.py` for the double integrator and
the time-optimal first-order kind; every other sweep (the time-optimal
double integrator, AL terms that do not fold) is the generic per-step sweep
(`ops/step_terms.py`), in plain tensor ops as the JAX package runs it in
XLA. The LTI kinds walk the line search on the affine trial family
(`_affine_family`, `_run_trials_affine`: one pass over the horizon, then
scan-free trials); the time-optimal kinds, whose B depends on u, re-roll
each trial (`_run_trials`): on the card every closed-loop rollout of the
first-order kind, the initial one included, is one launch of
`ops/cuda_kernels/rollout_time1.py`, and the double integrator's is a loop
of tensor ops. The joint-limit penalty over whole trajectories (each
trial's cost, read from the affine family's base and direction; the
sweep's streamed stage rows) is one launch of
`ops/cuda_kernels/limit_penalty.py` on the card. Lanes freeze one by one (early stop alpha sqrt(sum ||du||)
< 1e-3 and cost < 1e-3, or the iteration budget); the loop ends when every
lane is frozen.

Scope (`fleet_supported`): kinds 'posorn', 'joint', 'point', 'posorn_time',
'joint_time' at nb_deriv 1 and 2, on a chain robot with or without an
object frame ('point' also on a planar robot), and sequential specs of
them. Subsystems on one robot share one FK walk, each applying its own
frame. Per-scenario keypoint overrides (`FLEET_OVERRIDES`) are bound to
lanes once a solve (`_bind_ov`): only the keypoint steps are gathered, the
scenario axis moved last.

AL-iLQR (`make_fleet_solver_al`): the same sweep with the constraint terms
of the active sets at every step, plain-cost line search, and the dual and
penalty update masked per lane. Uniform constraints whose rows each touch
one state coordinate and no control (axis-aligned state bounds) fold
exactly into the streamed stage diagonal and gradient, so such a solve runs
the unconstrained kernels.

The host's work is in spans (`utils/compilemeter.py`): `fleet.iteration`,
`fleet.backward`, `fleet.line_search`, `fleet.rollout`, `stage_terms`; each
host read of a loop or trial guard is a `sync` (`host_read`).
"""
import math

import numpy as np
import torch

from ilqr_planner_torch.models.planar import FD_STEP
from ilqr_planner_torch.ops.cuda_kernels.limit_penalty import (limit_arrays,
                                                               limit_cost)
from ilqr_planner_torch.ops.cuda_kernels.rollout_time1 import rollout_time1
from ilqr_planner_torch.ops.cuda_kernels.segment_backward import segment_backward
from ilqr_planner_torch.ops.cuda_kernels.segment_backward_2nd import (
    segment_backward_2nd, segment_backward_time1)
from ilqr_planner_torch.ops.step_terms import al_terms, gains_value, q_terms
from ilqr_planner_torch.solvers.al_ilqr import ALILQRResult, Constraints
from ilqr_planner_torch.solvers.ilqr import ILQRResult
from ilqr_planner_torch.systems.spec import Spec, split_overrides
from ilqr_planner_torch.utils.compilemeter import host_read, span, spanned

__all__ = ["make_fleet_solver", "make_fleet_solver_al", "fleet_supported",
           "FLEET_OVERRIDES", "TRIALS", "GENERIC_SWEEPS"]

# Spec leaves the fleet takes per scenario (besides q0/x0).
FLEET_OVERRIDES = ("mu", "prec", "pos_radius", "orn_thresh")

_REG = 1e-6  # gain-elimination ridge

# Line-search trials run by fleet solves so far (each backward sweep is one
# iteration of the lane with the most).
TRIALS = 0
# Backward sweeps that ran the generic per-step sweep (no kernel) so far.
GENERIC_SWEEPS = 0


def _sub_ok(s: Spec) -> bool:
    if s.kind in ("joint", "joint_time"):
        return s.nb_deriv in (1, 2)
    if s.robot is None:
        return False
    if s.kind == "point":
        return s.nb_deriv in (1, 2) and (
            s.robot.kind == "chain"
            or (s.robot.kind == "planar" and s.robot.frame is None))
    if s.kind in ("posorn", "posorn_time"):
        return s.nb_deriv in (1, 2) and s.robot.kind == "chain"
    return False


def fleet_supported(spec: Spec) -> bool:
    """True when this spec is in the port's fleet scope."""
    if spec.kind == "sequential":
        return bool(spec.subs) and all(_sub_ok(s) for s in spec.subs)
    return _sub_ok(spec)


# ---------------------------------------------------------------------------
# host-side constants
# ---------------------------------------------------------------------------

class _SubC:
    """Constants of one system (a subsystem of a sequential spec), as
    tensors in the spec's dtype and device."""

    def __init__(self, spec: Spec, ov_names=()):
        self.kind = spec.kind
        self.nb_deriv = spec.nb_deriv
        self.time = spec.time_optimal
        self.n = spec.nx
        self.dof = spec.dof
        self.nt = spec.nt
        self.nq = spec.nq_var
        self.ov_names = tuple(ov_names)
        np_dtype = np.dtype(str(spec.dtype).removeprefix("torch."))
        dev = spec.device

        def f(a):
            return np.asarray(a.detach().cpu().numpy(), np_dtype)

        def t(a):
            return torch.as_tensor(np.asarray(a, np_dtype), device=dev)

        self.Rt = t(f(spec.Rt))
        self.limits_set = spec.limits_set
        if self.limits_set:
            self.smax = t(f(spec.state_max))
            self.smin = t(f(spec.state_min))
            self.weight = t(f(spec.limit_weight))
            self.penalty = float(f(spec.penalty))
        # the robot: a chain or planar key (subsystems on one robot share a
        # walk) and the object frame as (R^T, origin [3, 1])
        self.chain_key = self.frame = None
        self.planar = False
        if not self.kind.startswith("joint"):
            self.car_dim = spec.robot.nb_car_dim
            if spec.robot.kind == "planar":
                self.planar = True
                lengths = [float(v) for v in f(spec.robot.planar.lengths)]
                self.lengths = t(lengths)[:, None]
                self.lengths_over_h = t([v / FD_STEP for v in lengths])[:, None]
                self.chain_key = ("planar", tuple(lengths))
            else:
                self._chain_consts(spec.robot.chain, f, t)
                if spec.robot.frame is not None:
                    T = spec.robot.frame.detach().cpu().numpy().astype(np.float64)
                    self.frame = (t(T[:3, :3].T), t(T[:3, 3])[:, None])

        mask = f(spec.kp_mask) != 0
        mu, prec = f(spec.mu), f(spec.prec)
        radius, thresh = f(spec.pos_radius), f(spec.orn_thresh)
        self.kp = []
        for k in np.nonzero(mask)[0]:
            kp = {"k": int(k), "mu": t(mu[k])[:, None], "prec": t(prec[k]),
                  "radius": float(radius[k]),
                  "thresh": [float(v) for v in thresh[k]]}
            if self.kind.startswith("posorn"):
                # the target quaternion as (raw, unit, all-zero): the raw
                # entries build E and the transport distance, the unit one
                # (normalized in float64 like the JAX package) is the
                # log-map base
                q_t = mu[k, self.car_dim:self.car_dim + 4].astype(np.float64)
                nrm = np.linalg.norm(q_t)
                kp["q"] = (t(q_t)[:, None], t(q_t / (nrm if nrm > 0 else 1.0))[:, None],
                           bool(np.all(q_t == 0)))
                w, x, y, z = q_t
                kp["E"] = t([[-x, w, -z, y], [-y, z, w, -x], [-z, -y, x, w]])
            self.kp.append(kp)
        self.kp_steps = tuple(d["k"] for d in self.kp)

    def _chain_consts(self, ch, f, t):
        self.origin_rot = t(f(ch.origin_rot))
        self.origin_pos = t(f(ch.origin_pos))
        self.axis = t(f(ch.axis))
        self.prismatic = [bool(v > 0) for v in f(ch.prismatic)]
        self.tip_rot = t(f(ch.tip_rot))
        self.tip_pos = t(f(ch.tip_pos))
        # Rodrigues constants per joint: K = [axis]x and K @ K, in float64
        # on the host, then rounded once to the working dtype
        self.skew, self.skew2 = [], []
        for a in f(ch.axis).astype(np.float64):
            K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                          [-a[1], a[0], 0.0]])
            self.skew.append(t(K)[:, :, None])
            self.skew2.append(t(K @ K)[:, :, None])
        self.chain_key = tuple(f(getattr(ch, name)).tobytes() for name in (
            "origin_rot", "origin_pos", "axis", "prismatic", "tip_rot",
            "tip_pos"))


class _Consts:
    """Problem constants of a fleet solve."""

    def __init__(self, spec: Spec, ov_names=()):
        if not fleet_supported(spec):
            raise ValueError(
                f"fleet scope: posorn/joint/point/posorn_time/joint_time at "
                f"nb_deriv 1-2 (point also on a frameless planar robot), and "
                f"sequential specs of them; got kind={spec.kind!r} "
                f"nb_deriv={spec.nb_deriv}")
        ov_names = tuple(ov_names)
        bad = set(ov_names) - set(FLEET_OVERRIDES)
        if bad:
            raise ValueError(f"unsupported fleet overrides: {sorted(bad)}")
        self.kind = spec.kind
        self.n = spec.nx
        self.m = spec.nu
        self.dof = spec.dof
        self.nb_deriv = spec.nb_deriv
        self.time = spec.time_optimal
        self.H = spec.horizon
        self.dtype = spec.dtype
        self.device = spec.device
        np_dtype = np.dtype(str(spec.dtype).removeprefix("torch."))
        self.dt = None if self.time else float(np.asarray(spec.dt.cpu().numpy(),
                                                          np_dtype))
        # the top-level Rt drives the sweep; each subsystem's own Rt enters
        # the cost value at its keypoint steps
        self.Rt = [float(v) for v in np.asarray(spec.Rt.cpu().numpy(), np_dtype)]
        subs = spec.subs if spec.kind == "sequential" else (spec,)
        self.subs = [_SubC(s, ov_names) for s in subs]
        self.limit_table = _limit_table(self.subs)
        self.ov_names = ov_names
        # one FK walk per robot, shared by the subsystems on it
        keys = {}
        self.chain_of = [None if sc.chain_key is None
                         else keys.setdefault(sc.chain_key, sc)
                         for sc in self.subs]
        steps = sorted({k for sc in self.subs for k in sc.kp_steps})
        self.kp_steps = tuple(steps)
        self.kp_at = {k: [(i, d) for i, sc in enumerate(self.subs)
                          for d in sc.kp if d["k"] == k] for k in steps}


# ---------------------------------------------------------------------------
# lane-major algebra: [i, j(, B)] tensors, the lane axis last
# ---------------------------------------------------------------------------

def _mm(A, Bm):
    """A [i, j(, B)] @ Bm [j, k(, B)] -> [i, k, B]."""
    A = A if A.dim() == 3 else A[..., None]     # constants get a lane axis
    Bm = Bm if Bm.dim() == 3 else Bm[..., None]
    return (A[:, :, None] * Bm[None]).sum(1)


def _mv(A, v):
    """A [i, j(, B)] @ v [j(, B)] -> [i, B]."""
    A = A if A.dim() == 3 else A[..., None]
    v = v if v.dim() == 2 else v[..., None]
    return (A * v[None]).sum(1)


# ---------------------------------------------------------------------------
# S^3 ops, lane-major (the zero guards of ops/sd.py). A quaternion operand
# is a triple (raw [4, B|1], unit [4, B|1], all-zero: a [B] mask, or a bool
# for a constant); at least one operand of each call has lanes.
# ---------------------------------------------------------------------------

def _q_unit(q):
    """to_unit_norm with the zero guard."""
    n = torch.sqrt((q * q).sum(0))
    return q / torch.where(n > 0, n, torch.ones_like(n))


def _q_lanes(q):
    """The operand triple of a lane quaternion [4, B]."""
    return q, _q_unit(q), (q == 0).all(0)


def _q_distance(n1, n2):
    """Geodesic distance with the hemisphere flip: the raw dot product,
    clamped, and arccos shifted by -pi when negative."""
    dclip = torch.clamp((n1 * n2).sum(0), -1.0, 1.0)
    ac = torch.arccos(dclip)
    return torch.where(dclip < 0, ac - math.pi, ac)


def _q_log_map(base, y):
    """log_map(base, y) with the zero guards, on operand triples."""
    _, b, b_zero = base
    _, yn, y_zero = y
    dot = (b * yn).sum(0)
    temp = yn - dot * b
    tn = torch.sqrt((temp * temp).sum(0))
    dist = _q_distance(b, yn)
    tsafe = torch.where(tn > 0, tn, torch.ones_like(tn))
    out = torch.where(tn == 0, torch.zeros_like(temp), dist * temp / tsafe)
    return torch.where(b_zero | y_zero, torch.zeros_like(out), out)


def _q_transport(v, b1, b2):
    """Parallel transport of the tangent v [4, B] from b1 to b2 (operand
    triples): the squared distance of the RAW entries, with the guards."""
    d = _q_distance(b1[0], b2[0])
    d2 = d * d
    l12 = _q_log_map(b1, b2)
    l21 = _q_log_map(b2, b1)
    coef = (l12 * v).sum(0) / torch.where(d2 > 0, d2, torch.ones_like(d2))
    out = torch.where(d2 == 0, v, v - coef * (l12 + l21))
    return torch.where(b1[2] | b2[2], v, out)


def _dquat_jac(q):
    """E(q) [3, 4(, B)] (w-first) of a quaternion [4(, B)]."""
    w, x, y, z = q
    return torch.stack([torch.stack([-x, w, -z, y]), torch.stack([-y, z, w, -x]),
                        torch.stack([-z, -y, x, w])])


def _quat_rate(quat, w3):
    """Quaternion rate 0.5 E(q)^T w, [4, B] from quat [4, B], w3 [3, B]."""
    return 0.5 * (_dquat_jac(quat) * w3[:, None]).sum(0)


# ---------------------------------------------------------------------------
# FK + geometric Jacobian, lane-major
# ---------------------------------------------------------------------------

def _fk_walk(sc: _SubC, q):
    """World chain walk, q [dof, B] -> (p [3, B], R [3, 3, B], zs, os_) with
    the world joint axes and origins as lists of [3, B]."""
    B = q.shape[-1]
    R = torch.eye(3, dtype=q.dtype, device=q.device)[..., None]
    p = torch.zeros(3, 1, dtype=q.dtype, device=q.device)
    zs, os_ = [], []
    for i in range(len(sc.prismatic)):
        p = p + _mv(R, sc.origin_pos[i])
        R = _mm(R, sc.origin_rot[i])
        z = _mv(R, sc.axis[i])
        if sc.prismatic[i]:
            p = p + z * q[i]
        else:
            Raa = (torch.eye(3, dtype=q.dtype, device=q.device)[..., None]
                   + torch.sin(q[i]) * sc.skew[i]
                   + (1.0 - torch.cos(q[i])) * sc.skew2[i])
            R = _mm(R, Raa)
        zs.append(z.expand(3, B))
        os_.append(p.expand(3, B))
    return p, R, zs, os_


def _walk_tip(sc: _SubC, p, R):
    """Apply the fixed tip transform: world EE pose."""
    return p + _mv(R, sc.tip_pos), _mm(R, sc.tip_rot)


def _walk_jac(sc: _SubC, zs, os_, p_ee):
    """World geometric Jacobian [6, dof, B] from the walk."""
    cols = []
    for z, o, prism in zip(zs, os_, sc.prismatic):
        if prism:
            cols.append(torch.cat([z, torch.zeros_like(z)]))
        else:
            cols.append(torch.cat([torch.linalg.cross(z, p_ee - o, dim=0), z]))
    return torch.stack(cols, dim=1)


def _mat_to_quat_soa(R):
    """Branchless Shepperd extraction over lanes, [3, 3, B] -> [4, B], the
    candidates of ops.so3.mat_to_quat: the scores tr and 2 m_ii - tr, the
    largest kept (the first on a tie); its quaternion is the matching row of
    the symmetric numerator matrix [[., w^T], [w, R + R^T]] (w the skew part
    of R) over s = 2 sqrt(1 + score), with s / 4 on the diagonal. The scores
    sum in another order than m00 - m11 - m22 (about 1 ulp)."""
    B = R.shape[-1]
    dg = torch.diagonal(R, dim1=0, dim2=1).T                  # [3, B]
    tr = dg.sum(0, keepdim=True)
    score = torch.cat([tr, 2.0 * dg - tr])                    # [4, B]
    best = torch.argmax(score, dim=0)
    s = 2.0 * torch.sqrt(torch.clamp(score.gather(0, best[None]) + 1.0,
                                     min=1e-30))               # [1, B]
    A = R - R.transpose(0, 1)
    w = torch.stack([A[2, 1], A[0, 2], A[1, 0]])
    num = torch.cat([torch.cat([torch.zeros_like(tr)[None], w[None]], 1),
                     torch.cat([w[:, None], R + R.transpose(0, 1)], 1)])
    row = num.gather(0, best[None, None].expand(1, 4, B))[0]  # [4, B]
    pick = torch.arange(4, device=R.device)[:, None] == best[None]
    q = torch.where(pick, 0.25 * s, row / s)
    return q / torch.sqrt((q * q).sum(0))


def _apply_frame(frame, p, R, J):
    """Express the world EE pose (p [3, B], R [3, 3, B]) and Jacobian (J
    [6, dof, B] or None) in an object frame (R_f^T, p_f): p' = R_f^T (p -
    p_f), R' = R_f^T R, J' = blockdiag(R_f^T, R_f^T) J."""
    RfT, pf = frame
    p2 = _mv(RfT, p - pf)
    R2 = _mm(RfT, R)
    if J is not None:
        J = torch.cat([_mm(RfT, J[:3]), _mm(RfT, J[3:])])
    return p2, R2, J


def _planar_walk(sc: _SubC, q, want_jac):
    """Planar FK over lanes, q [dof, B] -> (p [3, B] with a zero third row,
    None, J6 [6, dof, B] or None): x = sum_i l_i [cos q_i, sin q_i], and the
    reference's forward-difference Jacobian with step pi * 1e-3. Joint i
    enters column i alone, so the column is l_i (cos(q_i + h) - cos q_i) / h
    (the difference of the full FK, with fewer operations); the rotational
    rows are zeros."""
    cos_q, sin_q = torch.cos(q), torch.sin(q)
    x = (sc.lengths * cos_q).sum(0)
    y = (sc.lengths * sin_q).sum(0)
    p = torch.stack([x, y, torch.zeros_like(x)])
    J6 = None
    if want_jac:
        J6 = q.new_zeros((6,) + tuple(q.shape))
        J6[0] = sc.lengths_over_h * (torch.cos(q + FD_STEP) - cos_q)
        J6[1] = sc.lengths_over_h * (torch.sin(q + FD_STEP) - sin_q)
    return p, None, J6


def _fk_subs(cc: _Consts, x, want_jac, want_vel=False):
    """Per-system kinematics at state x [n, B], in each system's object
    frame: None for the joint kinds, else {"p", "quat" (posorn), "J6" (when
    want_jac or want_vel), "dp", "w", "dquat" (posorn) (when want_vel: J_v
    dq, J_w dq and the quaternion rate, dq the velocity block of a
    double-integrator state)}. One world walk a robot, shared by the
    systems on it."""
    q = x[:cc.dof]
    jac = want_jac or want_vel
    walks, out = {}, []
    for sc, rep in zip(cc.subs, cc.chain_of):
        if rep is None:
            out.append(None)
            continue
        if sc.chain_key not in walks:
            if rep.planar:
                walks[sc.chain_key] = _planar_walk(rep, q, jac)
            else:
                p, R, zs, os_ = _fk_walk(rep, q)
                p_ee, R_ee = _walk_tip(rep, p, R)
                walks[sc.chain_key] = (p_ee, R_ee, _walk_jac(rep, zs, os_, p_ee)
                                       if jac else None)
        p, R, J = walks[sc.chain_key]
        if sc.frame is not None:
            p, R, J = _apply_frame(sc.frame, p, R, J)
        d = {"p": p}
        if jac:
            d["J6"] = J
        if sc.kind.startswith("posorn"):
            d["quat"] = _mat_to_quat_soa(R)
        if want_vel:
            dq = x[cc.dof:2 * cc.dof]
            d["dp"] = (J[:3] * dq[None]).sum(1)
            d["w"] = (J[3:] * dq[None]).sum(1)
            if sc.kind.startswith("posorn"):
                d["dquat"] = _quat_rate(d["quat"], d["w"])
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# per-scenario overrides, bound to lanes once a solve
# ---------------------------------------------------------------------------

def _bind_ov(cc: _Consts, ov):
    """The override arrays (a leading scenario axis: mu [B, H, nt], prec
    [B, H, nq, nq], pos_radius [B, H], orn_thresh [B, H, 3]; for a
    sequential spec a list with one entry a subsystem, None keeping that
    subsystem's constants) -> the keypoint table `kp_at` with each
    overridden keypoint's constants bound to lanes (mu [nt, B], prec
    [nq, nq, B], radius [B], thresh [3, B]; a target quaternion's E and
    unit operand recomputed from its lanes). Only the keypoint steps are
    gathered, and the scenario axis is moved last once."""
    if not cc.ov_names:
        return cc.kp_at
    missing = [k for k in cc.ov_names if k not in (ov or {})]
    if missing:
        raise ValueError(f"missing override arrays: {missing}")
    parts = split_overrides(cc.kind, len(cc.subs),
                            {k: ov[k] for k in cc.ov_names})
    bound = []
    for sc, part in zip(cc.subs, parts):
        lanes = {}
        for name, v in part.items():
            v = torch.as_tensor(v, dtype=cc.dtype, device=cc.device)
            want = {"mu": (cc.H, sc.nt), "prec": (cc.H, sc.nq, sc.nq),
                    "pos_radius": (cc.H,), "orn_thresh": (cc.H, 3)}[name]
            if tuple(v.shape[1:]) != want:
                raise ValueError(f"override {name!r} must be [B, "
                                 f"{', '.join(map(str, want))}], got "
                                 f"{tuple(v.shape)}")
            steps = torch.tensor(sc.kp_steps, dtype=torch.long, device=cc.device)
            lanes[name] = v[:, steps].movedim(0, -1).contiguous()   # [K, .., B]
        bound.append([_bind_kp(sc, kp, j, lanes) for j, kp in enumerate(sc.kp)])
    return {k: [(i, bound[i][j]) for i, sc in enumerate(cc.subs)
                for j, d in enumerate(sc.kp) if d["k"] == k]
            for k in cc.kp_steps}


def _bind_kp(sc: _SubC, kp: dict, j: int, lanes: dict) -> dict:
    """Keypoint j of a system with its overridden constants taken from the
    lane tensors (each [K, .., B], K the system's keypoints)."""
    if not lanes:
        return kp
    out = dict(kp)
    if "mu" in lanes:
        out["mu"] = lanes["mu"][j]
        if sc.kind.startswith("posorn"):
            # E(q*) from the RAW target quaternion, the log-map base its
            # unit lanes
            q_t = out["mu"][sc.car_dim:sc.car_dim + 4]
            out["q"] = _q_lanes(q_t)
            out["E"] = _dquat_jac(q_t)
    if "prec" in lanes:
        out["prec"] = lanes["prec"][j]
    if "pos_radius" in lanes:
        out["radius"] = lanes["pos_radius"][j]
    if "orn_thresh" in lanes:
        out["thresh"] = lanes["orn_thresh"][j]
    return out


# ---------------------------------------------------------------------------
# keypoint residuals + Gauss-Newton terms at one static step
# ---------------------------------------------------------------------------

def _posorn_residual_soa(sc: _SubC, kp: dict, fkd: dict):
    """Position + orientation residual [6(+6), B]: r_p = p* - p,
    r_o = -2 E(q*) logMap(q*, q), with the optional dead zones; second
    order appends dp* - dp and -2 E(q*)(dq* - transport(dquat, q -> q*)).
    The keypoint's constants may be bound to lanes (`_bind_kp`)."""
    c = sc.car_dim
    mu = kp["mu"]
    quat = _q_lanes(fkd["quat"])
    r_p = mu[:c] - fkd["p"]
    r_o = -2.0 * _mv(kp["E"], _q_log_map(kp["q"], quat))
    # the dead zones: skipped only where the radius or threshold is a
    # constant zero, applied whenever an override binds it to lanes
    radius = kp["radius"]
    if isinstance(radius, torch.Tensor) or radius != 0.0:
        nrm = torch.sqrt((r_p * r_p).sum(0))
        safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        r_p = torch.where(nrm <= radius, torch.zeros_like(r_p),
                          r_p / safe * (nrm - radius))
    th = kp["thresh"]
    if not isinstance(th, torch.Tensor) and any(v != 0.0 for v in th):
        th = torch.tensor(th, dtype=r_o.dtype, device=r_o.device)[:, None]
    if isinstance(th, torch.Tensor):
        r_o = torch.where(r_o.abs() <= th, torch.zeros_like(r_o),
                          r_o - torch.sign(r_o) * th)
    parts = [r_p, r_o]
    if sc.nb_deriv == 2:
        tv = _q_transport(fkd["dquat"], quat, kp["q"])
        parts += [mu[c + 4:2 * c + 4] - fkd["dp"],
                  -2.0 * _mv(kp["E"], mu[2 * c + 4:2 * c + 8] - tv)]
    return torch.cat(parts)


def _kp_residual(sc: _SubC, kp: dict, fkd, x):
    """Residual e [nq, B] of one keypoint at its step."""
    if sc.kind.startswith("joint"):
        return kp["mu"] - x[:sc.n]          # unguarded Euclidean residual
    if sc.kind == "point":
        fx = fkd["p"][:sc.car_dim]
        if sc.nb_deriv == 2:
            fx = torch.cat([fx, fkd["dp"][:sc.car_dim]])
        return kp["mu"] - fx
    e = _posorn_residual_soa(sc, kp, fkd)
    # zero-state guard over the pos/orn forward map; the time row is
    # appended unguarded
    fx = [fkd["p"], fkd["quat"]]
    if sc.nb_deriv == 2:
        fx += [fkd["dp"], fkd["dquat"]]
    zero_state = (torch.cat(fx) == 0).all(0)
    e = torch.where(zero_state, torch.zeros_like(e), e)
    if sc.time:
        e = torch.cat([e, kp["mu"][sc.nt - 1:] - x[sc.n - 1:sc.n]])
    return e


def _kp_jac(sc: _SubC, fkd):
    """Residual-row Jacobian [nq, n, B]: the geometric rows once per
    derivative block, and the unit time row of the time kinds."""
    J6 = fkd["J6"]
    core = 6 if sc.kind.startswith("posorn") else sc.car_dim
    J = J6.new_zeros((sc.nq, sc.n, J6.shape[-1]))
    for b in range(sc.nb_deriv):
        J[b * core:(b + 1) * core, b * sc.dof:(b + 1) * sc.dof] = J6[:core]
    if sc.time:
        J[sc.nq - 1, sc.n - 1] = 1.0
    return J


@spanned("stage_terms")
def _kp_terms_at(cc: _Consts, k: int, x, want_grads: bool, kpa=None):
    """(cost [B], gx [n, B], Gxx [n, n, B]) summed over the keypoints of
    every system at step k: cost = e^T P e, gx = J^T P e, Gxx = J^T P J.
    gx/Gxx are None when want_grads is False. `kpa` is the keypoint table
    with overrides bound (`_bind_ov`), `cc.kp_at` when None."""
    entries = (cc.kp_at if kpa is None else kpa)[k]
    need_fk = any(not cc.subs[i].kind.startswith("joint") for i, _ in entries)
    want_vel = cc.nb_deriv == 2 and need_fk
    fkds = (_fk_subs(cc, x, want_grads, want_vel) if need_fk
            else [None] * len(cc.subs))
    cost = gx = Gxx = None
    for i, kp in entries:
        sc = cc.subs[i]
        e = _kp_residual(sc, kp, fkds[i], x)
        P = kp["prec"]
        v = _mv(P, e)
        c = (e * v).sum(0)
        cost = c if cost is None else cost + c
        if not want_grads:
            continue
        if sc.kind.startswith("joint"):      # J = I
            gs = v
            Gs = P if P.dim() == 3 else P[..., None].expand(-1, -1, e.shape[-1])
        else:
            J = _kp_jac(sc, fkds[i])         # [nq, n, B]
            gs = (J * v[:, None]).sum(0)
            Gs = (J[:, :, None] * _mm(P, J)[:, None]).sum(0)
        gx = gs if gx is None else gx + gs
        Gxx = Gs if Gxx is None else Gxx + Gs
    return cost, gx, Gxx


# ---------------------------------------------------------------------------
# joint-limit penalty over whole trajectories
# ---------------------------------------------------------------------------

def _limit_table(subs):
    """The limited subsystems' (smax, smin, weight, penalty) rows
    [nsub, 4, n], in subsystem order; None where no subsystem sets limits."""
    rows = [torch.stack([sc.smax, sc.smin, sc.weight,
                         torch.full_like(sc.smax, sc.penalty)])
            for sc in subs if sc.limits_set]
    return torch.stack(rows) if rows else None


@spanned("stage_terms")
def _limit_arrays(cc: _Consts, X):
    """Negated limit gradient and diagonal Hessian over [H, n, B]:
    (lx = -Lq, L2), one `limit_penalty` launch on the card."""
    if cc.limit_table is None:
        L2 = torch.zeros_like(X)
        return -L2, L2
    return limit_arrays(X, table=cc.limit_table)


@spanned("stage_terms")
def _limit_cost_full(cc: _Consts, X, Xd=None, alpha=0.0):
    """Total limit-penalty cost [B] of a trajectory [H, n, B], or of the
    affine trial X + alpha Xd (read from X and Xd, never formed), one
    `limit_penalty` launch on the card."""
    if cc.limit_table is None:
        return torch.zeros_like(X[0, 0])
    return limit_cost(X, Xd, alpha, table=cc.limit_table)


# ---------------------------------------------------------------------------
# closed-loop rollout and the static keypoint-step costs
# ---------------------------------------------------------------------------

@spanned("stage_terms")
def _static_step_costs(cc: _Consts, X, U, cost, kpa=None):
    """Add the keypoint-residual and control-penalty costs at the keypoint
    steps to `cost` ([H, n, B], [H-1, m, B] -> [B]). The control penalty
    enters the cost value only at each system's keypoint steps, with that
    system's Rt."""
    for k in cc.kp_steps:
        if k < cc.H - 1:
            for i_sub, _ in cc.kp_at[k]:
                Rt = cc.subs[i_sub].Rt[:, None]
                cost = cost + (Rt * U[k] * U[k]).sum(0)
        kc, _, _ = _kp_terms_at(cc, k, X[k], False, kpa)
        cost = cost + kc
    return cost


@spanned("fleet.rollout")
def _rollout(cc: _Consts, alpha, Ks, ds, Xref, Uref, x0, kpa=None):
    """Closed-loop rollout u = uo + K (x - xo) + alpha d over all lanes ->
    (X [H, n, B], U [H-1, m, B], cost [B], sum_k ||du_k|| [B]).

    Ks [H-1, m, n, B], ds/Uref [H-1, m, B], Xref [H, n, B], x0 [n, B]. The
    time-optimal first-order kind runs `rollout_time1` (the CUDA kernel for
    CUDA tensors, its twin on the CPU); the other kinds integrate x' = x +
    dt u (first order) or semi-implicit Euler (double integrator; the
    time-optimal one with the step's duration s^2, s = u[m-1], and the time
    state advanced by it). The whole solve's initial rollout is this with
    zero gains and alpha = 0."""
    if cc.time and cc.nb_deriv == 1:
        X, U, du2 = rollout_time1(alpha, Ks, ds, Xref, Uref, x0)
    else:
        dt, dof = cc.dt, cc.dof
        X = x0.new_empty((cc.H,) + tuple(x0.shape))
        U = x0.new_empty(tuple(Uref.shape))
        du2 = x0.new_empty((cc.H - 1, x0.shape[-1]))
        X[0] = x = x0
        for k in range(cc.H - 1):
            du = (Ks[k] * (x - Xref[k])[None]).sum(1) + alpha * ds[k]
            u = Uref[k] + du
            if cc.time:
                s = u[cc.m - 1]
                dtk = s * s
                q, dq, ddq = x[:dof], x[dof:2 * dof], u[:dof]
                x = torch.cat([q + dtk * dq + (0.5 * dtk * dtk) * ddq,
                               dq + dtk * ddq, x[2 * dof:] + dtk])
            elif cc.nb_deriv == 2:
                x = torch.cat([x[:dof] + dt * x[dof:] + (0.5 * dt * dt) * u,
                               x[dof:] + dt * u])
            else:
                x = x + dt * u
            X[k + 1], U[k], du2[k] = x, u, (du * du).sum(0)
    cost = _static_step_costs(cc, X, U, _limit_cost_full(cc, X), kpa)
    return X, U, cost, torch.sqrt(du2).sum(0)


# ---------------------------------------------------------------------------
# backward sweep
# ---------------------------------------------------------------------------

def _sweep_kind(cc: _Consts) -> str:
    """The structured dynamics of the spec, as `ops/step_terms.py` names
    them."""
    if cc.time:
        return "time2" if cc.nb_deriv == 2 else "time1"
    return "second" if cc.nb_deriv == 2 else "first"


def _fold_al(al, L2, lx_all):
    """The diagonal-AL fold: where every constraint row touches one state
    coordinate j and no control, its backward terms are exactly a stage
    update, Qxx += coef^2 Ik at (j, j) and Qx += coef (lam + Ik g) at j, so
    they add into the streamed L2 / lx rows of steps 0..H-2 ->
    (L2, lx_all)."""
    Is, lam = al["Is"], al["lam"]                     # [H-1, nc, B]
    lig = lam + Is * al["g"]
    add2 = torch.zeros_like(L2[:-1])
    addx = torch.zeros_like(add2)
    for c, j, coef in al["fold"]:
        add2[:, j] += (coef * coef) * Is[:, c]
        addx[:, j] += coef * lig[:, c]
    L2, lx_all = L2.clone(), lx_all.clone()
    L2[:-1] += add2
    lx_all[:-1] += addx
    return L2, lx_all


def _generic_sweep(cc: _Consts, P, p, L2, lx, U, gxx, inner, X, al):
    """The per-step sweep in tensor ops: `q_terms` of the spec's dynamics,
    the AL terms where `al` is set, then `gains_value`, over the H-1 steps
    in reverse; a keypoint step adds its dense Hessian from the slot table
    `gxx` [n_kp, n, n, B] (slots in the order of `inner`)."""
    global GENERIC_SWEEPS
    GENERIC_SWEEPS += 1
    kind = _sweep_kind(cc)
    H, dof = cc.H, cc.dof
    dt = 0.0 if cc.dt is None else cc.dt
    Rt = torch.tensor(cc.Rt, dtype=X.dtype, device=X.device)[:, None]
    slot = {k: i for i, k in enumerate(inner)}
    dq = X[:H - 1, dof:2 * dof] if kind == "time2" else None
    Ks = X.new_empty((H - 1, cc.m, cc.n, X.shape[-1]))
    ds = X.new_empty((H - 1, cc.m, X.shape[-1]))
    for t in range(H - 2, -1, -1):
        Q = q_terms(kind, P, p, L2[t], lx[t], U[t],
                    gxx[slot[t]] if t in slot else None, dt, 0.5 * dt * dt,
                    Rt, None if dq is None else dq[t])
        if al is not None:
            cx, cu = ((al["cx"], al["cu"]) if al["uniform"]
                      else (al["cx"][t], al["cu"][t]))
            Q = al_terms(*Q, cx, cu, al["Is"][t], al["g"][t], al["lam"][t])
        P, p, Ks[t], ds[t] = gains_value(*Q, _REG)
    return Ks, ds


@spanned("fleet.backward")
def _backward(cc: _Consts, X, U, kpa=None, al=None):
    """Full backward sweep -> (Ks [H-1, m, n, B], ds [H-1, m, B]).

    The limit quadratics stream as per-step diagonals; the keypoint
    gradients fold into the stage-gradient rows, and the dense keypoint
    Hessians J^T P J enter only at the inner keypoint steps. The terminal
    cost-to-go (cost at H-1 with u = 0) is built here. Without AL terms
    (`al` None, or folded into the stage rows: `_fold_al`) the sweep runs
    in a whole-sweep kernel for CUDA tensors, its twin on the CPU:
    `segment_backward` (first order, m = n), `segment_backward_2nd` (double
    integrator, n = 2m) or `segment_backward_time1` (time-optimal first
    order, m = n); the time-optimal double integrator and AL terms that do
    not fold run `_generic_sweep`. `al`: {"fold", "uniform", "cx", "cu"
    (constraint rows [nc, n] / [nc, m], per step [H-1, nc, .] when not
    uniform), "Is", "g", "lam" [H-1, nc, B]}.
    """
    H = cc.H
    lx_all, L2 = _limit_arrays(cc, X)
    if al is not None and al["fold"]:
        L2, lx_all = _fold_al(al, L2, lx_all)
        al = None
    eye = torch.eye(cc.n, dtype=X.dtype, device=X.device)[..., None]
    P = eye * L2[H - 1][:, None]
    p = lx_all[H - 1]
    if (H - 1) in cc.kp_at:
        _, gx, gxx = _kp_terms_at(cc, H - 1, X[H - 1], True, kpa)
        p = p - gx
        P = P + gxx
    inner = [k for k in cc.kp_steps if k < H - 1]
    lx = lx_all[:H - 1]
    if inner:
        terms = [_kp_terms_at(cc, k, X[k], True, kpa) for k in inner]
        for k, (_, gx_k, _) in zip(inner, terms):
            lx[k] = lx[k] - gx_k
        gxx = torch.stack([g for _, _, g in terms])
    else:
        gxx = X.new_zeros((0, cc.n, cc.n, X.shape[-1]))
    kind = _sweep_kind(cc)
    if al is not None or kind == "time2":
        return _generic_sweep(cc, P, p, L2, lx, U, gxx, inner, X, al)
    args = (P.contiguous(), p.contiguous(), L2[:H - 1].contiguous(),
            lx.contiguous(), U.contiguous(), gxx.contiguous(), tuple(inner))
    if kind == "time1":
        return segment_backward_time1(*args, cc.Rt, _REG)
    if kind == "second":
        return segment_backward_2nd(*args, cc.dt, cc.Rt, _REG)
    return segment_backward(*args, cc.dt, cc.Rt, _REG)


# ---------------------------------------------------------------------------
# line search. The LTI kinds: the closed-loop trial dynamics are affine in
# both x and alpha, so X(alpha) = Xb + alpha Xd and U(alpha) = Ub + alpha Ud
# from one pass, and each trial is a few whole-array passes with no
# recursion. The time-optimal kinds (B depends on u): one rollout a trial.
# ---------------------------------------------------------------------------

def _alpha_schedule(line_search: bool):
    return [2.0 ** -i for i in range(11)] if line_search else [1.0]


def _check_auto(**knobs):
    """Raise on a backward or rollout knob other than 'auto': the port has
    one implementation of each (the kernel on the card, its twin on the
    CPU)."""
    for name, value in knobs.items():
        if value != "auto":
            raise ValueError(f"{name} must be 'auto' in the port, got {value!r}")


def _pick_ls_mode(cc: _Consts, ls: str) -> bool:
    """The line-search knob -> use the affine family. 'auto': affine for
    the LTI kinds, re-rollouts for the time-optimal kinds; 'affine' on a
    time-optimal kind raises (its trials are not affine in alpha)."""
    if ls not in ("auto", "affine", "scan"):
        raise ValueError(f"ls must be auto/affine/scan, got {ls!r}")
    if ls == "affine" and cc.time:
        raise ValueError(
            "ls='affine' requires LTI dynamics; the sqrt-dt time-optimal "
            "kinds have a control-dependent B, so trial trajectories are not "
            "affine in alpha")
    return ls == "affine" or (ls == "auto" and not cc.time)


def _affine_family(cc: _Consts, Ks, ds, Xref, Uref, x0):
    """The exact affine trial family: Xb/Xd [H, n, B], Ub/Ud [H-1, m, B],
    and the per-step ||du||^2 coefficients (a, b, c) [H-1, B] with
    ||du_k(alpha)||^2 = a_k + 2 alpha b_k + alpha^2 c_k.

    Base (alpha = 0) and direction are carried together as [2, n, B]: the
    direction's reference state and control are zero, so one product with
    K serves both."""
    H, dt, dof = cc.H, cc.dt, cc.dof
    B = x0.shape[-1]
    zX = torch.zeros_like(Xref[:-1])
    ref_x = torch.stack([Xref[:-1], zX], dim=1)            # [H-1, 2, n, B]
    ref_u = torch.stack([Uref, torch.zeros_like(Uref)], dim=1)
    Xbd = x0.new_empty((H, 2) + tuple(x0.shape))
    Xbd[0, 0] = x0
    Xbd[0, 1] = 0.0
    DU = x0.new_empty((H - 1, 2, cc.m, B))
    xbd = Xbd[0]
    for k in range(H - 1):
        du = (Ks[k][None] * (xbd - ref_x[k])[:, None]).sum(2)  # [2, m, B]
        du[1] += ds[k]
        DU[k] = du
        v = du + ref_u[k]
        if cc.nb_deriv == 2:
            # semi-implicit Euler, on the base and (linearly) the direction
            q, dq = xbd[:, :dof], xbd[:, dof:]
            xbd = torch.cat([q + dt * dq + (0.5 * dt * dt) * v, dq + dt * v],
                            dim=1)
        else:
            xbd = xbd + dt * v
        Xbd[k + 1] = xbd
    dub, dud = DU[:, 0], DU[:, 1]
    return (Xbd[:, 0], Xbd[:, 1], Uref + dub, dud, (dub * dub).sum(1),
            (dub * dud).sum(1), (dud * dud).sum(1))


@spanned("fleet.line_search")
def _run_trials_affine(cc: _Consts, a_sched, X, U, cost0, Ks, ds, x0,
                       inactive, kpa=None):
    """Backtracking over alpha = 1, 1/2, ..., 2^-10 on the affine family:
    the first passing alpha is adopted per lane, the last trial on
    floor-out; the walk stops once every lane has accepted. Inactive lanes
    start as accepted. -> (Xn, Un, cost, sum ||du||, alpha, trials run)."""
    Xb, Xd, Ub, Ud, qa, qb, qc = _affine_family(cc, Ks, ds, X, U, x0)
    H = cc.H

    def trial(a):
        cost = _limit_cost_full(cc, Xb, Xd, a)
        for k in cc.kp_steps:
            if k < H - 1:
                uk = Ub[k] + a * Ud[k]
                for i_sub, _ in cc.kp_at[k]:
                    cost = cost + (cc.subs[i_sub].Rt[:, None] * uk * uk).sum(0)
            kc, _, _ = _kp_terms_at(cc, k, Xb[k] + a * Xd[k], False, kpa)
            cost = cost + kc
        # ||du_k(alpha)||^2 >= 0 exactly; clamp the rounding tail
        du = torch.sqrt(torch.clamp(qa + (2.0 * a) * qb + (a * a) * qc,
                                    min=0.0)).sum(0)
        return cost, du

    accepted = inactive.clone()
    cost = cost0
    du_acc = torch.zeros_like(cost0)
    alpha = torch.ones_like(cost0)
    n_trials = 0
    for a in a_sched:
        if host_read(accepted.all()):
            break
        ct, dut = trial(a)
        n_trials += 1
        ok = (ct < cost0) & ~torch.isnan(ct)
        take = ~accepted
        cost = torch.where(take, ct, cost)
        du_acc = torch.where(take, dut, du_acc)
        alpha = torch.where(take, torch.full_like(alpha, a), alpha)
        accepted = accepted | ok
    Xn = Xb + alpha * Xd
    Un = Ub + alpha * Ud
    return Xn, Un, cost, du_acc, alpha, n_trials


@spanned("fleet.line_search")
def _run_trials(cc: _Consts, a_sched, X, U, cost0, Ks, ds, x0, inactive,
                kpa=None):
    """Backtracking with one closed-loop rollout (`_rollout`) a trial, same
    decisions as `_run_trials_affine` (first passing alpha per lane, the
    last trial on floor-out, early exit once every lane has accepted); the
    time-optimal kind's trial is one `rollout_time1` launch on the card.
    -> (Xn, Un, cost, sum ||du||, alpha, trials run)."""
    accepted = inactive.clone()
    best = (X, U, cost0, torch.zeros_like(cost0), torch.ones_like(cost0))
    n_trials = 0
    for a in a_sched:
        if host_read(accepted.all()):
            break
        Xt, Ut, ct, dut = _rollout(cc, a, Ks, ds, X, U, x0, kpa)
        n_trials += 1
        ok = (ct < cost0) & ~torch.isnan(ct)
        take = ~accepted
        best = tuple(torch.where(take, new, old) for old, new in
                     zip(best, (Xt, Ut, ct, dut, torch.full_like(ct, a))))
        accepted = accepted | ok
    return best + (n_trials,)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@spanned("stage_terms")
def _fx_traj(cc: _Consts, X):
    """fX [B, H, nt] of a trajectory: the horizon flattens into the lane
    axis so the FK walk runs once over H*B lanes."""
    H, n = cc.H, cc.n
    B = X.shape[-1]
    x_flat = X.permute(1, 0, 2).reshape(n, H * B)
    want_vel = cc.nb_deriv == 2
    comps = []
    for sc, fkd in zip(cc.subs, _fk_subs(cc, x_flat, False, want_vel)):
        if sc.kind.startswith("joint"):
            comps.append(x_flat[:sc.n])
            continue
        if sc.kind == "point":
            comps.append(fkd["p"][:sc.car_dim])
            if want_vel:
                comps.append(fkd["dp"][:sc.car_dim])
        else:
            comps += [fkd["p"], fkd["quat"]]
            if want_vel:
                comps += [fkd["dp"], fkd["dquat"]]
        if sc.time:
            comps.append(x_flat[n - 1:n])
    fx = torch.cat(comps)
    return fx.reshape(fx.shape[0], H, B).permute(2, 1, 0)


def make_fleet_solver(spec: Spec, nb_iter: int, line_search: bool = True,
                      early_stop: bool = True, overrides=(),
                      backward: str = "auto", ls: str = "auto",
                      record: bool = False, rollout: str = "auto"):
    """Build a lane-major fleet solve: (x0s [B, n], U0s [B, H-1, nu][, ov])
    -> ILQRResult with a leading scenario axis, on the spec's device.

    overrides: names from FLEET_OVERRIDES that vary per scenario; the solve
    then takes `ov`, a dict of arrays with a leading scenario axis (mu
    [B, H, nt], prec [B, H, nQ, nQ], pos_radius [B, H], orn_thresh
    [B, H, 3]; for a sequential spec a list with one entry a subsystem,
    None keeping that subsystem's constants), bound to lanes once a solve.
    record: `progress` holds each lane's {"cost", "alpha"} [B, nb_iter],
    written at the lane's own iteration index, NaN beyond its last.
    backward, rollout: 'auto' only (the CUDA kernels on the card, their
    twins on the CPU; the time-optimal rollout kernel on the first-order
    time-optimal kind's re-rollouts). ls: 'auto' (the affine trials on the
    LTI kinds, re-rollouts on the time-optimal kinds), 'affine' or 'scan'
    to force ('affine' on a time-optimal kind raises).
    """
    _check_auto(backward=backward, rollout=rollout)
    cc = _Consts(spec, overrides)
    use_affine = _pick_ls_mode(cc, ls)
    run_trials = _run_trials_affine if use_affine else _run_trials
    n, m, H = cc.n, cc.m, cc.H
    a_sched = _alpha_schedule(line_search)

    def solve(x0s, U0s, ov=None):
        global TRIALS
        x0 = torch.as_tensor(x0s, dtype=cc.dtype, device=cc.device).T.contiguous()
        U0 = torch.as_tensor(U0s, dtype=cc.dtype,
                             device=cc.device).permute(1, 2, 0).contiguous()
        kpa = _bind_ov(cc, ov)
        B = x0.shape[-1]
        Ks = x0.new_zeros((H - 1, m, n, B))
        ds = x0.new_zeros((H - 1, m, B))
        X, U, cost, _ = _rollout(cc, 0.0, Ks, ds, x0.new_zeros((H, n, B)), U0,
                                 x0, kpa)
        it = torch.zeros(B, dtype=torch.int32, device=cc.device)
        done = torch.zeros(B, dtype=torch.bool, device=cc.device)
        alpha = torch.ones_like(cost)
        if record:
            rec_cost = cost.new_full((nb_iter, B), float("nan"))
            rec_alpha = rec_cost.clone()
            rows = torch.arange(nb_iter, device=cc.device)[:, None]
        while True:
            with span("fleet.iteration"):
                active = ~done & (it < nb_iter)
                if not host_read(active.any()):
                    break
                Ks_n, ds_n = _backward(cc, X, U, kpa)
                Xn, Un, costn, du_acc, alpha_n, n_trials = run_trials(
                    cc, a_sched, X, U, cost, Ks_n, ds_n, x0, ~active, kpa)
                TRIALS += n_trials
                new_done = done
                if early_stop:
                    new_done = done | ((alpha_n * torch.sqrt(du_acc) < 1e-3)
                                       & (costn < 1e-3))
                if record:
                    # each active lane's row at its own iteration index
                    row = (rows == it[None]) & active[None]
                    rec_cost = torch.where(row, costn[None], rec_cost)
                    rec_alpha = torch.where(row, alpha_n[None], rec_alpha)
                X = torch.where(active, Xn, X)
                U = torch.where(active, Un, U)
                cost = torch.where(active, costn, cost)
                Ks = torch.where(active, Ks_n, Ks)
                ds = torch.where(active, ds_n, ds)
                it = torch.where(active, it + 1, it)
                done = torch.where(active, new_done, done)
                alpha = torch.where(active, alpha_n, alpha)
        return ILQRResult(
            X=X.permute(2, 0, 1),
            fX=_fx_traj(cc, X),
            U=U.permute(2, 0, 1),
            Ks=Ks.permute(3, 0, 1, 2),
            ds=(ds * alpha).permute(2, 0, 1),
            cost=cost,
            iterations=it,
            alpha=alpha,
            progress=({"cost": rec_cost.T, "alpha": rec_alpha.T}
                      if record else None),
        )

    return solve


# ---------------------------------------------------------------------------
# AL-iLQR
# ---------------------------------------------------------------------------

def _al_plan(constraints: Constraints, n: int, np_dtype) -> dict:
    """The host-side plan of a constraint set A [H-1, nc, n+m], b [H-1, nc]
    -> {"nc", "uniform" (the same rows at every step), "fold" (None, or
    (row c, state coordinate j, coefficient) for each row that folds:
    `_fold_al`), "A", "b" (numpy, in the spec's dtype)}. The fold needs
    uniform rows that touch no control and at most one state coordinate
    each; an all-zero row is inert and folds to nothing."""
    A = np.asarray(torch.as_tensor(constraints.A).detach().cpu().numpy(), np_dtype)
    b = np.asarray(torch.as_tensor(constraints.b).detach().cpu().numpy(), np_dtype)
    nc = A.shape[1]
    uniform = bool(np.all(A == A[0]) and np.all(b == b[0]))
    fold = None
    if (uniform and np.all(A[0, :, n:] == 0)
            and np.all(np.count_nonzero(A[0, :, :n], axis=1) <= 1)):
        fold = [(c, int(nz[0]), float(A[0, c, nz[0]])) for c in range(nc)
                for nz in [np.nonzero(A[0, c, :n])[0]] if nz.size == 1] or None
    return {"nc": nc, "uniform": uniform, "fold": fold, "A": A, "b": b}


def make_fleet_solver_al(spec: Spec, constraints: Constraints, nb_iter: int,
                         lag_update_step: int, penalty: float,
                         scaling_factor: float, line_search: bool = True,
                         early_stop: bool = True, ls: str = "auto",
                         backward: str = "auto"):
    """Build a lane-major AL-iLQR solve: (x0s [B, n], U0s [B, H-1, nu],
    lam0 [nc] | [H-1, nc] | [B, H-1, nc]) -> ALILQRResult with a leading
    scenario axis, on the spec's device. Per lane it is `al_ilqr.solve`:
    the line search accepts on the plain cost, the active sets come from
    the accepted trajectory with the pre-update lam and penalty, the
    penalty (x scaling_factor) and then lam = max(0, lam + penalty g) update
    every `lag_update_step` iterations, and a lane stops early at
    alpha sqrt(sum ||du||) < 1e-3 (no cost condition). The constraints
    A [H-1, nc, n+m], b [H-1, nc] are shared by every lane. ls and
    backward as in `make_fleet_solver`."""
    _check_auto(backward=backward)
    cc = _Consts(spec)
    run_trials = _run_trials_affine if _pick_ls_mode(cc, ls) else _run_trials
    n, m, H = cc.n, cc.m, cc.H
    a_sched = _alpha_schedule(line_search)
    plan = _al_plan(constraints, n, np.dtype(str(cc.dtype).removeprefix("torch.")))
    A = torch.as_tensor(plan["A"], device=cc.device)
    b = torch.as_tensor(plan["b"], device=cc.device)[:, :, None]
    al_static = {"fold": plan["fold"], "uniform": plan["uniform"],
                 "cx": A[0, :, :n] if plan["uniform"] else A[:, :, :n],
                 "cu": A[0, :, n:] if plan["uniform"] else A[:, :, n:]}
    # the violation's products, one a state or control coordinate that some
    # row touches (the temporaries scale with those coordinates, not with
    # nc x (n+m) per lane and step); elementwise, so no reduced-precision
    # matmul enters g, where AL converges
    cols = [j for j in range(n + m) if np.any(plan["A"][:, :, j] != 0)]

    def active_sets(X, U, lam, pen):
        """Penalty-scaled active sets and violations [H-1, nc, B]."""
        XU = torch.cat([X[:-1], U], dim=1)                  # [H-1, n+m, B]
        g = -b.expand(H - 1, plan["nc"], X.shape[-1])
        if cols:
            acc = A[:, :, cols[0], None] * XU[:, None, cols[0]]
            for j in cols[1:]:
                acc = acc + A[:, :, j, None] * XU[:, None, j]
            g = acc - b
        inactive = (g < 0) & (lam == 0)
        return pen * torch.where(inactive, 0.0, 1.0).to(X.dtype), g

    def solve(x0s, U0s, lam0):
        global TRIALS
        x0 = torch.as_tensor(x0s, dtype=cc.dtype, device=cc.device).T.contiguous()
        U0 = torch.as_tensor(U0s, dtype=cc.dtype,
                             device=cc.device).permute(1, 2, 0).contiguous()
        B = x0.shape[-1]
        lam = torch.as_tensor(lam0, dtype=cc.dtype, device=cc.device)
        if lam.dim() == 3:                    # per-scenario duals
            lam = lam.permute(1, 2, 0)
        else:
            lam = lam.expand(H - 1, plan["nc"])[..., None]
        lam = lam.expand(H - 1, plan["nc"], B).contiguous()
        pen = torch.full((B,), penalty, dtype=cc.dtype, device=cc.device)
        X, U, cost, _ = _rollout(cc, 0.0, x0.new_zeros((H - 1, m, n, B)),
                                 x0.new_zeros((H - 1, m, B)),
                                 x0.new_zeros((H, n, B)), U0, x0)
        Is, g = active_sets(X, U, lam, pen)
        it = torch.zeros(B, dtype=torch.int32, device=cc.device)
        done = torch.zeros(B, dtype=torch.bool, device=cc.device)
        while True:
            with span("fleet.iteration"):
                active = ~done & (it < nb_iter)
                if not host_read(active.any()):
                    break
                Ks, ds = _backward(cc, X, U, None, dict(al_static, Is=Is, g=g, lam=lam))
                Xn, Un, costn, du_acc, alpha, n_trials = run_trials(
                    cc, a_sched, X, U, cost, Ks, ds, x0, ~active)
                TRIALS += n_trials
                Isn, gn = active_sets(Xn, Un, lam, pen)
                update = ((it + 1) % lag_update_step) == 0
                pen_n = torch.where(update, pen * scaling_factor, pen)
                lam_n = torch.where(update, torch.clamp_min(lam + pen_n * gn, 0.0),
                                    lam)
                new_done = done
                if early_stop:
                    new_done = done | (alpha * torch.sqrt(du_acc) < 1e-3)
                X = torch.where(active, Xn, X)
                U = torch.where(active, Un, U)
                Is = torch.where(active, Isn, Is)
                g = torch.where(active, gn, g)
                cost = torch.where(active, costn, cost)
                lam = torch.where(active, lam_n, lam)
                pen = torch.where(active, pen_n, pen)
                it = torch.where(active, it + 1, it)
                done = torch.where(active, new_done, done)
        return ALILQRResult(X=X.permute(2, 0, 1), fX=_fx_traj(cc, X),
                            U=U.permute(2, 0, 1),
                            multipliers=lam.permute(2, 0, 1), cost=cost,
                            iterations=it)

    return solve
