"""PyLQR.system: keypoints and planner systems (bindings.cpp:219-692).

The port's counterpart of the JAX package's `compat/system.py`. A System
pairs a mutable robot (`compat.sim`) with a dense `Spec`, built by the
port's `make_spec` / `sequential_spec` on the robot's device and in its
dtype; the solvers consume the Spec. The stateful methods (forward_pass
drives the robot, reset rewinds it; System.h:66,159) mirror the
reference, and every accessor returns numpy, as the JAX ones do.
"""

import numpy as np
import torch

from ilqr_planner_torch.compat.sim import SimulationInterface
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems import keypoints as _kp
from ilqr_planner_torch.systems.spec import make_spec, sequential_spec

__all__ = [
    "Keypoint",
    "PosOrnKeypoint",
    "PosOrnKeypointDistFunct",
    "SpacetimeKeypoint",
    "AngularKeypoint",
    "AngularTimeKeypoint",
    "System",
    "PosOrnPlannerSys",
    "PosOrnTimePlannerSys",
    "JointSpacePlannerSys",
    "JointSpaceTimePlannerSys",
    "SequentialSystem",
]

Keypoint = _kp.Keypoint


def _np(t):
    return t.detach().cpu().numpy()


class _KpAccessors:
    """Reference keypoint getters (bindings.cpp:262-411)."""

    def get_position(self):
        return np.asarray(self.position)

    def get_orientation(self):
        return np.asarray(self.orientation)

    def get_precision(self):
        return np.asarray(self.precision)

    def get_timestep(self):
        return self.timestep

    def get_state(self):
        return self.state()

    def get_continuous_time(self):
        return getattr(self, "continuous_time", None)


class PosOrnKeypoint(_kp.PosOrnKeypoint, _KpAccessors):
    """First order: PosOrnKeypoint(pos, orn, Q, timestep).
    Second order: PosOrnKeypoint(pos, dpos, orn, dorn, Q, timestep)
    (constructor overloads of bindings.cpp:262-311)."""

    def __init__(self, *args, **kwargs):
        if len(args) == 6 and not kwargs:
            pos, dpos, orn, dorn, Q, ts = args
            super().__init__(pos, orn, Q, ts, dposition=dpos, dorientation=dorn)
        else:
            super().__init__(*args, **kwargs)


class PosOrnKeypointDistFunct(_kp.PosOrnKeypointDistFunct, _KpAccessors):
    """First order: (pos, orn, Q, pos_thresh, orn_thresh, timestep).
    Second order: (pos, dpos, orn, dorn, Q, pos_thresh, orn_thresh, timestep)
    (bindings.cpp:303-306)."""

    def __init__(self, *args, **kwargs):
        if len(args) == 6 and not kwargs:
            pos, orn, Q, pos_thresh, orn_thresh, ts = args
            super().__init__(pos, orn, Q, ts, pos_radius=pos_thresh,
                             orn_thresh=orn_thresh)
        elif len(args) == 8 and not kwargs:
            pos, dpos, orn, dorn, Q, pos_thresh, orn_thresh, ts = args
            super().__init__(pos, orn, Q, ts, pos_radius=pos_thresh,
                             orn_thresh=orn_thresh, dposition=dpos,
                             dorientation=dorn)
        else:
            super().__init__(*args, **kwargs)


class SpacetimeKeypoint(_kp.SpacetimeKeypoint, _KpAccessors):
    """First order: SpacetimeKeypoint(pos, orn, Q, continuous_time, timestep).
    Second order: (pos, dpos, orn, dorn, Q, continuous_time, timestep)."""

    def __init__(self, *args, **kwargs):
        if len(args) == 5 and not kwargs:
            pos, orn, Q, ct, ts = args
            super().__init__(pos, orn, Q, ts, ct)
        elif len(args) == 7 and not kwargs:
            pos, dpos, orn, dorn, Q, ct, ts = args
            super().__init__(pos, orn, Q, ts, ct, dposition=dpos, dorientation=dorn)
        else:
            super().__init__(*args, **kwargs)


class AngularKeypoint(_kp.AngularKeypoint, _KpAccessors):
    """AngularKeypoint(q, Q, timestep) or (q, dq, Q, timestep)."""

    def __init__(self, *args, **kwargs):
        if len(args) == 4 and not kwargs:
            q, dq, Q, ts = args
            super().__init__(q, Q, ts, dposition=dq)
        else:
            super().__init__(*args, **kwargs)


class AngularTimeKeypoint(_kp.AngularTimeKeypoint, _KpAccessors):
    """AngularTimeKeypoint(q, Q, continuous_time, timestep) or
    (q, dq, Q, continuous_time, timestep)."""

    def __init__(self, *args, **kwargs):
        if len(args) == 4 and not kwargs:
            q, Q, ct, ts = args
            super().__init__(q, Q, ts, ct)
        elif len(args) == 5 and not kwargs:
            q, dq, Q, ct, ts = args
            super().__init__(q, Q, ts, ct, dposition=dq)
        else:
            super().__init__(*args, **kwargs)


class System:
    """Base wrapper: couples (robot, Spec) and exposes the reference System
    API (System.h:28-194, bindings.cpp:413-692)."""

    def __init__(self, r: SimulationInterface, spec, keypoints):
        self.r = r
        self.spec = spec
        self.keypoints = sorted(keypoints, key=lambda kp: kp.timestep)

    def _t(self, a):
        """A numpy input as a tensor on the spec's device, in its dtype."""
        return torch.as_tensor(np.asarray(a, float), dtype=self.spec.dtype,
                               device=self.spec.device)

    # -- dims / metadata ----------------------------------------------------
    def get_nb_state_var(self):
        return self.spec.nx

    def get_nb_ctrl_var(self):
        return self.spec.nu

    def get_nb_target_var(self):
        return self.spec.nt

    def get_nb_Q_var(self):
        return self.spec.nq_var

    def get_horizon(self):
        return self.spec.horizon

    def get_nb_deriv(self):
        return self.spec.nb_deriv

    def get_kp_indexes(self):
        return [kp.timestep for kp in self.keypoints]

    def get_init_state(self):
        return _np(self.spec.x0)

    def get_init_fx_state(self):
        return _np(funcs.fx_jac(self.spec, self.spec.x0)[0])

    # -- state --------------------------------------------------------------
    def reset(self):
        self.r.set_conf(_np(self.spec.q0), _np(self.spec.dq0))

    def get_state(self):
        parts = [self.r.get_q()]
        if self.spec.nb_deriv == 2:
            parts.append(self.r.get_dq())
        if self.spec.time_optimal:
            parts.append([self.r.get_time()])
        return np.concatenate(parts)

    # -- forward map --------------------------------------------------------
    def get_fx_jac(self, xk=None):
        x = self.get_state() if xk is None else xk
        fx, J = funcs.fx_jac(self.spec, self._t(x))
        return _np(fx), _np(J)

    def _apply_state(self, x):
        dof = self.spec.dof
        q = x[:dof]
        dq = x[dof:2 * dof] if self.spec.nb_deriv == 2 else np.zeros(dof)
        self.r.set_conf(q, dq, reset_time=False)
        if self.spec.time_optimal:
            self.r.set_time(float(x[-1]))

    def forward_pass(self, xk, uk, k):
        """(x_{k+1}, f(x_{k+1}), A, B, J): also drives the robot, like the
        reference (PosOrnPlannerSys.cpp:114-138)."""
        x1, A, B = funcs.dynamics(self.spec, self._t(xk), self._t(uk))
        self._apply_state(_np(x1))
        fx, J = funcs.fx_jac(self.spec, x1)
        return _np(x1), _np(fx), _np(A), _np(B), _np(J)

    def forward_pass_with_limits(self, xk, uk, k):
        x1, fx, A, B, J = self.forward_pass(xk, uk, k)
        if self.spec.limits_set:
            Ld, ql = (_np(a) for a in funcs.limit_terms(self.spec, self._t(xk)))
        else:
            Ld, ql = np.zeros(self.spec.nx), np.zeros(self.spec.nx)
        return (x1, fx, ql, np.zeros(self.spec.nu), A, B, J, np.diag(Ld))

    def forward_pass_batch(self, u):
        """fpBatch (System.cpp:181-211): the open-loop rollout ->
        (f(X) flattened, the lagged limit violations flattened, one
        (A, B, J, L) a step, the first (I, 0, J_0, L_0))."""
        from ilqr_planner_torch.solvers.batch import _open_loop_rollout

        spec = self.spec
        U = self._t(u).reshape(1, spec.horizon - 1, spec.nu)
        X, As, Bs, Ldiag, qL = (a[0] for a in _open_loop_rollout(
            spec, spec.x0[None], U))
        fX, Js = funcs.fx_jac(spec, X)
        self.reset()
        As, Bs, Js, Ldiag = _np(As), _np(Bs), _np(Js), _np(Ldiag)
        return (_np(fX).reshape(-1), _np(qL).reshape(-1),
                [(As[i - 1] if i > 0 else np.eye(spec.nx),
                  Bs[i - 1] if i > 0 else np.zeros((spec.nx, spec.nu)),
                  Js[i], np.diag(Ldiag[i]))
                 for i in range(spec.horizon)])

    # -- residuals / costs --------------------------------------------------
    def diff(self, state, k):
        return _np(funcs.residual(self.spec, self._t(state), k))

    def diff_batch(self, x):
        nt = self.spec.nt
        rows = np.asarray(x, float).reshape(-1, nt)
        return np.concatenate([
            self.diff(rows[i], kp.timestep) for i, kp in enumerate(self.keypoints)
        ])

    def cost(self, xk, uk, k):
        x = self._t(xk)
        fx, _ = funcs.fx_jac(self.spec, x)
        return np.array([float(funcs.stage_cost(self.spec, x, fx,
                                                self._t(uk), k))])

    def cost_F(self, xk):
        x = self._t(xk)
        fx, _ = funcs.fx_jac(self.spec, x)
        return np.array([float(funcs.final_cost(self.spec, x, fx))])

    def _grads(self, xk, uk, k):
        x = self._t(xk)
        fx, J = funcs.fx_jac(self.spec, x)
        return funcs.cost_gradients(self.spec, x, fx, J, self._t(uk), k)

    def cost_x(self, xk, uk, k):
        return _np(self._grads(xk, uk, k)[0])

    def cost_u(self, xk, uk, k):
        return _np(self.spec.Rt) * np.asarray(uk, float)

    def cost_xx(self, xk, uk, k):
        return _np(self._grads(xk, uk, k)[2])

    def cost_uu(self, xk, uk, k):
        return np.diag(_np(self.spec.Rt))

    def cost_ux(self, xk, uk, k):
        return np.zeros((self.spec.nu, self.spec.nx))

    def cost_xu(self, xk, uk, k):
        return np.zeros((self.spec.nx, self.spec.nu))

    def cost_F_x(self, xk):
        return self.cost_x(xk, np.zeros(self.spec.nu), self.spec.horizon - 1)

    def cost_F_xx(self, xk):
        return self.cost_xx(xk, np.zeros(self.spec.nu), self.spec.horizon - 1)

    # -- target stacking (System.cpp:321-361) -------------------------------
    def get_mu_vector(self, sparse=True):
        nt = self.spec.nt
        if sparse:
            return np.concatenate([kp.state() for kp in self.keypoints])
        mu = np.zeros(self.spec.horizon * nt)
        for kp in self.keypoints:
            mu[kp.timestep * nt:(kp.timestep + 1) * nt] = kp.state()
        return mu

    def get_Q_matrix(self, sparse=True):
        nq = self.spec.nq_var
        if sparse:
            n = len(self.keypoints)
            Q = np.zeros((n * nq, n * nq))
            for i, kp in enumerate(self.keypoints):
                Q[i * nq:(i + 1) * nq, i * nq:(i + 1) * nq] = kp.precision
            return Q
        Q = np.zeros((self.spec.horizon * nq, self.spec.horizon * nq))
        for kp in self.keypoints:
            t = kp.timestep
            Q[t * nq:(t + 1) * nq, t * nq:(t + 1) * nq] = kp.precision
        return Q


def _make_planner(kind, tag_cls):
    """Factory for the four concrete planner wrappers, handling the
    reference's 3 constructor arities (no limits / q limits / q+dq limits).
    The Spec lives on the robot's device, in its dtype."""

    class Planner(System):
        def __init__(self, r, keypoints, RtDiag, *args):
            time_kind = kind.endswith("_time")
            tail = 2 if time_kind else 3  # (horizon, nb_deriv[, dt])
            nlim = len(args) - tail
            lims = args[:nlim]
            if time_kind:
                horizon, nb_deriv = args[nlim:]
                dt = None
            else:
                horizon, nb_deriv, dt = args[nlim:]
            kw = {}
            if nlim >= 2:
                kw["q_max"], kw["q_min"] = lims[0], lims[1]
            if nlim == 4:
                kw["dq_max"], kw["dq_min"] = lims[2], lims[3]
            nu = r.get_dof() + (1 if time_kind else 0)
            spec = make_spec(kind, r.robot, keypoints,
                             np.asarray(RtDiag, float).reshape(nu),
                             int(horizon), int(nb_deriv), dt=dt,
                             q0=r.get_q(), dq0=r.get_dq(), dtype=r.dtype,
                             device=r.device, **kw)
            super().__init__(r, spec, keypoints)

    Planner.__name__ = tag_cls
    Planner.__qualname__ = tag_cls
    Planner.__doc__ = f"Reference {tag_cls} (kind={kind!r}) over a dense Spec."
    return Planner


PosOrnPlannerSys = _make_planner("posorn", "PosOrnPlannerSys")
PosOrnTimePlannerSys = _make_planner("posorn_time", "PosOrnTimePlannerSys")
JointSpacePlannerSys = _make_planner("joint", "JointSpacePlannerSys")
JointSpaceTimePlannerSys = _make_planner("joint_time", "JointSpaceTimePlannerSys")


class SequentialSystem(System):
    """Composite system over subsystems sharing robot/state/control
    (SequentialSystem.cpp:13-76, bindings.cpp:612-692)."""

    def __init__(self, r, systems, RtDiag, horizon=None, nbDeriv=None):
        self.systems = list(systems)
        spec = sequential_spec(tuple(s.spec for s in systems),
                               np.asarray(RtDiag, float), dtype=r.dtype)
        kps = [kp for s in systems for kp in s.keypoints]
        super().__init__(r, spec, kps)

    def get_mu_vector(self, sparse=True):
        nt = self.spec.nt
        if sparse:
            out = []
            for kp in self.keypoints:
                row = []
                for s in self.systems:
                    hit = [k for k in s.keypoints if k.timestep == kp.timestep]
                    row.append(hit[0].state() if hit
                               else np.zeros(s.spec.nt))
                out.append(np.concatenate(row))
            return np.concatenate(out)
        mu = np.zeros(self.spec.horizon * nt)
        off = 0
        for s in self.systems:
            sub = s.get_mu_vector(False).reshape(self.spec.horizon, s.spec.nt)
            for j in range(self.spec.horizon):
                mu[j * nt + off: j * nt + off + s.spec.nt] = sub[j]
            off += s.spec.nt
        return mu

    def get_Q_matrix(self, sparse=True):
        nq = self.spec.nq_var
        if sparse:
            n = len(self.keypoints)
            Q = np.zeros((n * nq, n * nq))
            for i, kp in enumerate(self.keypoints):
                off = 0
                for s in self.systems:
                    hit = [k for k in s.keypoints if k.timestep == kp.timestep]
                    if hit:
                        b = hit[0].precision
                        Q[i * nq + off:i * nq + off + s.spec.nq_var,
                          i * nq + off:i * nq + off + s.spec.nq_var] = b
                    off += s.spec.nq_var
            return Q
        Q = np.zeros((self.spec.horizon * nq, self.spec.horizon * nq))
        off = 0
        for s in self.systems:
            sub = s.get_Q_matrix(False)
            for j in range(self.spec.horizon):
                Q[j * nq + off:j * nq + off + s.spec.nq_var,
                  j * nq + off:j * nq + off + s.spec.nq_var] = (
                    sub[j * s.spec.nq_var:(j + 1) * s.spec.nq_var,
                        j * s.spec.nq_var:(j + 1) * s.spec.nq_var])
            off += s.spec.nq_var
        return Q

    def reset(self):
        for s in self.systems:
            s.reset()
        super().reset()
