"""Problem specification: the optimal-control problem as a dataclass of
tensors.

PyTorch counterpart of the JAX package's `systems/spec.py`. Keypoints are
scattered into dense per-timestep tensors (targets `mu[H, nt]`, precisions
`prec[H, nQ, nQ]`, presence mask `kp_mask[H]`) on the host at build time.

Kinds, first order (nb_deriv=1) and double integrator (nb_deriv=2):
  'posorn'       end-effector position + quaternion tracking
  'joint'        joint-space tracking
  'point'        end-effector position tracking
  'posorn_time'  'posorn' with a continuous-time state and a sqrt-dt control
  'joint_time'   'joint' likewise
  'sequential'   subsystems sharing the state and control, their targets
                 concatenated (`sequential_spec`)
A time-optimal state is [q, t] (first order) or [q, dq, t] (double
integrator), its control [dq or ddq, s] with the step's duration s^2.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ilqr_planner_torch.models.robot import Robot
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["Spec", "make_spec", "sequential_spec", "split_overrides"]

_KIND_CHECK = {
    "posorn": ("POS_ORN",),
    "posorn_time": ("POS_ORN_TIME",),
    "joint": ("JNT",),
    "joint_time": ("JNT_TIME",),
    "point": ("POINT",),
}


def _target_dim(kind: str, nb_deriv: int, car_dim: int, dof: int) -> int:
    """Width of the forward-map target (mu rows)."""
    if kind.startswith("joint"):
        nt = dof * nb_deriv
    elif kind.startswith("posorn"):
        nt = (car_dim + 4) * nb_deriv
    else:  # point
        nt = car_dim * nb_deriv
    return nt + (1 if kind.endswith("_time") else 0)


@dataclasses.dataclass
class Spec:
    """Dense problem description. mu rows use the forward-map layout of each
    kind ([p, quat] for posorn), the layout the residual consumes."""

    kind: str
    nb_deriv: int
    horizon: int
    limits_set: bool

    robot: Optional[Robot] = None
    subs: Tuple["Spec", ...] = ()

    dt: Optional[torch.Tensor] = None          # fixed step (0 for time kinds)
    mu: Optional[torch.Tensor] = None          # [H, nt]
    prec: Optional[torch.Tensor] = None        # [H, nQ, nQ]
    kp_mask: Optional[torch.Tensor] = None     # [H] 0/1
    pos_radius: Optional[torch.Tensor] = None  # [H] dead-zone radius (posorn)
    orn_thresh: Optional[torch.Tensor] = None  # [H, 3] per-axis dead zones
    Rt: Optional[torch.Tensor] = None          # [nu] control penalty diagonal
    state_min: Optional[torch.Tensor] = None   # [nx]
    state_max: Optional[torch.Tensor] = None   # [nx]
    limit_weight: Optional[torch.Tensor] = None  # [nx] 0/1 mask
    penalty: Optional[torch.Tensor] = None     # scalar, 1 when limits set
    x0: Optional[torch.Tensor] = None          # [nx]
    q0: Optional[torch.Tensor] = None          # [dof]
    dq0: Optional[torch.Tensor] = None         # [dof]

    @property
    def dof(self) -> int:
        return (self.subs[0] if self.kind == "sequential" else self).q0.shape[-1]

    @property
    def time_optimal(self) -> bool:
        k = self.subs[0].kind if self.kind == "sequential" else self.kind
        return k.endswith("_time")

    @property
    def nx(self) -> int:
        return self.x0.shape[-1]

    @property
    def nu(self) -> int:
        return self.Rt.shape[-1]

    @property
    def nt(self) -> int:
        if self.kind == "sequential":
            return sum(s.nt for s in self.subs)
        return self.mu.shape[-1]

    @property
    def nq_var(self) -> int:
        """Residual dimension (a quaternion's 4 entries give 3)."""
        if self.kind == "sequential":
            return sum(s.nq_var for s in self.subs)
        return self.prec.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x0.dtype

    def tensors(self) -> dict:
        """Every tensor leaf by name: the robot's under 'robot.*', each
        subsystem's under 'subs.<i>.*'."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if isinstance(getattr(self, f.name), torch.Tensor)}
        if self.robot is not None:
            out.update({f"robot.{k}": v for k, v in self.robot.tensors().items()})
        for i, sub in enumerate(self.subs):
            out.update({f"subs.{i}.{k}": v for k, v in sub.tensors().items()})
        return out


def _limit_arrays(dof, nb_deriv, q_max, q_min, dq_max, dq_min, time_axis, dtype):
    """state_min/max and the limit weight mask, with the time kinds'
    zero-padded, zero-weighted time slot."""
    limits_set = q_max is not None
    nx = dof * nb_deriv + (1 if time_axis else 0)
    if not limits_set:
        zeros = np.zeros(nx)
        return False, zeros, zeros, np.zeros(nx), 0.0
    q_max = np.asarray(q_max, float)
    q_min = np.asarray(q_min, float)
    weight = np.ones(dof * nb_deriv)
    if nb_deriv == 1:
        smax, smin = q_max, q_min
    else:
        if dq_max is None:
            dq_max = np.zeros(dof)
            dq_min = np.zeros(dof)
        dq_max = np.asarray(dq_max, float)
        dq_min = np.asarray(dq_min, float)
        smax = np.concatenate([q_max, dq_max])
        smin = np.concatenate([q_min, dq_min])
        if np.allclose(dq_max, dq_min):
            weight[dof:] = 0.0  # velocity block masked out
    if time_axis:
        smax = np.concatenate([smax, [0.0]])
        smin = np.concatenate([smin, [0.0]])
        weight = np.concatenate([weight, [0.0]])
    return True, smax.astype(dtype), smin.astype(dtype), weight.astype(dtype), 1.0


def make_spec(kind: str, robot: Robot, keypoints, Rt_diag, horizon: int,
              nb_deriv: int, dt: float = None, q0=None, dq0=None, q_max=None,
              q_min=None, dq_max=None, dq_min=None, dtype=torch.float64,
              device=None) -> Spec:
    """Build a dense Spec for one system kind on `device` (None: CUDA).

    Validates keypoint tags and orders and builds the limit arrays and the
    initial state like the JAX `make_spec`. The robot (chain or planar, with
    its object frame) is moved to the spec's device.
    """
    if kind not in _KIND_CHECK:
        raise ValueError(f"unknown system kind {kind!r}")
    time_axis = kind.endswith("_time")
    if nb_deriv not in (1, 2):
        raise ValueError(f"nb_deriv must be 1 or 2, got {nb_deriv}")
    for kp in keypoints:
        if kp.TAG not in _KIND_CHECK[kind]:
            raise ValueError(f"[{kind}] Wrong keypoint type: got {kp.TAG}")
        if kp.order != nb_deriv:
            raise ValueError(
                f"[{kind}] Wrong keypoint order (nb_deriv): expecting "
                f"{nb_deriv} got {kp.order}")
    if not time_axis and dt is None:
        raise ValueError("dt is required for non-time-optimal systems")
    dev = resolve_device(device)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    dof = robot.dof
    q0 = np.zeros(dof) if q0 is None else np.asarray(q0, float)
    dq0 = np.zeros(dof) if dq0 is None else np.asarray(dq0, float)

    nt = _target_dim(kind, nb_deriv, robot.nb_car_dim, dof)
    # residual width: a quaternion (4) gives a tangent (3) per derivative
    nq = nt - nb_deriv if kind.startswith("posorn") else nt

    H = horizon
    mu = np.zeros((H, nt), dtype=np_dtype)
    prec = np.zeros((H, nq, nq), dtype=np_dtype)
    kp_mask = np.zeros(H, dtype=np_dtype)
    pos_radius = np.zeros(H, dtype=np_dtype)
    orn_thresh = np.zeros((H, 3), dtype=np_dtype)
    for kp in keypoints:
        k = kp.timestep
        if not (0 <= k < H):
            raise ValueError(f"keypoint timestep {k} outside horizon {H}")
        mu[k] = kp.fx_state()
        prec[k] = kp.precision
        kp_mask[k] = 1.0
        if hasattr(kp, "pos_radius"):
            pos_radius[k] = kp.pos_radius
            orn_thresh[k] = kp.orn_thresh

    limits_set, smax, smin, weight, penalty = _limit_arrays(
        dof, nb_deriv, q_max, q_min, dq_max, dq_min, time_axis, np_dtype)
    x0 = [q0] if nb_deriv == 1 else [q0, dq0]
    if time_axis:
        x0.append([0.0])
    x0 = np.concatenate(x0)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np_dtype), device=dev)

    robot = robot.to(dev)
    return Spec(
        kind=kind,
        nb_deriv=nb_deriv,
        horizon=H,
        limits_set=limits_set,
        robot=robot,
        dt=t(0.0 if dt is None else dt),
        mu=t(mu),
        prec=t(prec),
        kp_mask=t(kp_mask),
        pos_radius=t(pos_radius),
        orn_thresh=t(orn_thresh),
        Rt=t(np.asarray(Rt_diag, float)),
        state_min=t(smin),
        state_max=t(smax),
        limit_weight=t(weight),
        penalty=t(penalty),
        x0=t(x0),
        q0=t(q0),
        dq0=t(dq0),
    )


def sequential_spec(subs, Rt_diag, dtype=torch.float64) -> Spec:
    """Compose subsystems that share the state and control spaces, their
    target spaces concatenated.

    Raises ValueError unless every subsystem has the same number of state
    and control variables, horizon, number of derivatives and initial state.
    The dynamics are subsystem 0's; the costs of the subsystems (each with
    its own control penalty and joint limits) add up, while the top-level
    Rt drives the solver's gradient and Hessian in u. On the subsystems'
    device.
    """
    subs = tuple(subs)
    s0 = subs[0]
    for s in subs[1:]:
        if s.nx != s0.nx:
            raise ValueError("All the systems do not have the same number of state variables")
        if s.nu != s0.nu:
            raise ValueError("All the systems do not have the same number of control variables")
        if s.horizon != s0.horizon:
            raise ValueError("All the systems do not have the same horizon")
        if s.nb_deriv != s0.nb_deriv:
            raise ValueError("All the systems do not have the same number of derivatives")
        if not np.allclose(s.x0.detach().cpu().numpy(), s0.x0.detach().cpu().numpy()):
            raise ValueError("All the systems do not have the same initState")
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np_dtype), device=s0.device)

    return Spec(
        kind="sequential",
        nb_deriv=s0.nb_deriv,
        horizon=s0.horizon,
        limits_set=False,   # the top level has no limits of its own
        subs=subs,
        Rt=t(np.asarray(Rt_diag, float)),
        x0=s0.x0,
        q0=s0.q0,
        dq0=s0.dq0,
        dt=s0.dt,
        penalty=t(0.0),
    )


def split_overrides(kind: str, n_subs: int, overrides) -> list:
    """Per-scenario leaf overrides {name: array} -> one dict a subsystem
    (a plain spec is one). A sequential spec takes each override as a list
    with one entry a subsystem, None keeping that subsystem's leaf; a plain
    spec takes arrays only."""
    if kind != "sequential":
        if any(isinstance(v, (list, tuple)) for v in overrides.values()):
            raise ValueError("list-valued overrides are only for sequential specs")
        return [dict(overrides)]
    for name, v in overrides.items():
        if not isinstance(v, (list, tuple)) or len(v) != n_subs:
            raise ValueError(
                f"sequential override {name!r} must be a list with one entry "
                f"per subsystem ({n_subs}), None to skip")
    return [{name: v[i] for name, v in overrides.items() if v[i] is not None}
            for i in range(n_subs)]
