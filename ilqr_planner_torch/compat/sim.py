"""PyLQR.sim: stateful robot wrappers (bindings.cpp:85-216).

The port's counterpart of the JAX package's `compat/sim.py`.
`SimulationInterface` carries the reference's mutable state (q, dq, ddq, t;
SimulationInterface.h:117-123) and exposes the same snake_case methods. The
robot is built once in float64 on the CPU, and held twice:
  * that float64 CPU robot, always kept, card or not, on which the state
    mirror runs (`update_kinematics` and the `get_*` / `J*` getters, numpy out):
    a replay loop reads it once a step, and a round trip to the card for
    seven joints would cost more than the kinematics. The JAX package runs
    the same mirror on its host CPU device for the same reason;
  * `robot`, the same robot cast to `device` (CUDA unless the caller passes
    device="cpu") and `dtype`: what the systems and solvers built over the
    wrapper use.
"""

import numpy as np
import torch

from ilqr_planner_torch.models.planar import PlanarRobot, planar_fk
from ilqr_planner_torch.models.robot import Robot, robot_kin
from ilqr_planner_torch.models.urdf import chain_from_urdf
from ilqr_planner_torch.ops import sd
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["SimulationInterface", "KDLRobot", "Robot2D",
           "TransformedSimulationInterface"]

_CPU = torch.device("cpu")


class SimulationInterface:
    """Abstraction of a robot (SimulationInterface.h:13-124) over a port
    `Robot` built in float64: the state mirror runs on it on the CPU, and
    the systems use its cast to `device` (None: CUDA) and `dtype`."""

    def __init__(self, robot: Robot, q, dq, *, device=None,
                 dtype=torch.float64):
        self._robot_cpu = robot.to(_CPU, torch.float64)
        self._robot = self._robot_cpu.to(resolve_device(device), dtype)
        self.q = np.asarray(q, float)
        self.dq = np.asarray(dq, float)
        self.ddq = np.zeros_like(self.q)
        self.t = 0.0
        self.update_kinematics()

    # -- kinematics ---------------------------------------------------------
    def update_kinematics(self):
        ks = robot_kin(self._robot_cpu, torch.from_numpy(self.q),
                       torch.from_numpy(self.dq))
        self._ks = {k: v.numpy() for k, v in vars(ks).items()}

    # -- commands (SimulationInterface.cpp:19-31) ---------------------------
    def send_acc(self, dt, ddq, update_kin=True):
        ddq = np.asarray(ddq, float)
        self.q = self.q + dt * self.dq + dt * dt / 2 * ddq
        self.dq = self.dq + dt * ddq
        self.t += dt
        if update_kin:
            self.update_kinematics()
        self.ddq = ddq

    def send_vel(self, dt, dq, update_kin=True):
        self.dq = np.asarray(dq, float)
        self.send_acc(dt, np.zeros_like(self.q), update_kin)

    def set_conf(self, q, dq, reset_time=True):
        self.q = np.asarray(q, float)
        self.dq = np.asarray(dq, float)
        self.update_kinematics()
        if reset_time:
            self.t = 0.0

    # -- getters ------------------------------------------------------------
    def get_q(self):
        return self.q.copy()

    def get_dq(self):
        return self.dq.copy()

    def get_ee_pos(self):
        return self._ks["x"].copy()

    def get_ee_orn(self):
        return self._ks["quat"].copy()

    def get_ee_vel(self):
        return self._ks["dx"].copy()

    def get_ee_ang_vel(self):
        return self._ks["w"].copy()

    def get_ee_ang_vel_quat(self):
        """0.5 E(q)^T w (SimulationInterface.cpp:69-73)."""
        return sd.quat_rate(torch.from_numpy(self._ks["quat"]),
                            torch.from_numpy(self._ks["w"])).numpy()

    def J(self):
        return self._ks["J"].copy()

    def Jp(self):
        return self._ks["dJ"].copy()

    def Jt(self):
        return self._ks["J"][:self.get_nb_car_dim()].copy()

    def Jr(self):
        return self._ks["J"][self.get_nb_car_dim():].copy()

    def Jtp(self):
        """Time derivative of the translational Jacobian rows
        (SimulationInterface.cpp:41-43, bound at bindings.cpp:93)."""
        return self._ks["dJ"][:self.get_nb_car_dim()].copy()

    def Jrp(self):
        """Time derivative of the rotational Jacobian rows
        (SimulationInterface.cpp:45-47, bound at bindings.cpp:94)."""
        return self._ks["dJ"][self.get_nb_car_dim():].copy()

    def get_dof(self):
        return self._robot.dof

    def get_nb_car_dim(self):
        return self._robot.nb_car_dim

    def get_time(self):
        return self.t

    def set_time(self, t):
        self.t = float(t)

    @property
    def robot(self) -> Robot:
        """The port robot, on the device the systems and solvers use."""
        return self._robot

    @property
    def device(self) -> torch.device:
        return next(iter(self._robot.tensors().values())).device

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self._robot.tensors().values())).dtype


class KDLRobot(SimulationInterface):
    """URDF kinematic-chain robot (KDLRobot.cpp:17-70), KDL-free; the
    systems' chain on `device` (None: CUDA) in `dtype`."""

    def __init__(self, urdf, base_frame, tip_frame, q, dq,
                 transform_rpy=(0.0, 0.0, 0.0), transform_xyz=(0.0, 0.0, 0.0),
                 is_path=True, *, device=None, dtype=torch.float64):
        chain = chain_from_urdf(urdf, base_frame, tip_frame,
                                transform_rpy=transform_rpy,
                                transform_xyz=transform_xyz, is_path=is_path,
                                dtype=torch.float64, device=_CPU)
        super().__init__(Robot.from_chain(chain), q, dq, device=device,
                         dtype=dtype)


class Robot2D(SimulationInterface):
    """Planar n-link robot (2DRobot.cpp:13-70); the systems' robot on
    `device` (None: CUDA) in `dtype`."""

    def __init__(self, lengths, default_q, *, device=None,
                 dtype=torch.float64):
        rob = PlanarRobot(lengths=torch.as_tensor(np.asarray(lengths, float)))
        super().__init__(Robot.from_planar(rob), default_q,
                         np.zeros_like(np.asarray(default_q, float)),
                         device=device, dtype=dtype)

    def fkine(self, q=None):
        q = self.q if q is None else np.asarray(q, float)
        return planar_fk(self._robot_cpu.planar, torch.from_numpy(q)).numpy()


class TransformedSimulationInterface(SimulationInterface):
    """EE quantities expressed in an object frame T
    (TransformedSimulationInterface.cpp:14-103), on the wrapped robot's
    device and dtype. Supports the deferred `subscribe` initialization
    variant (cpp:20-29)."""

    def __init__(self, r=None, T=None):
        if T is None:  # called as TransformedSimulationInterface(T)
            r, T = None, r
        self.T = np.asarray(T, float)
        self._base = None
        if r is not None:
            self.subscribe(r)

    def subscribe(self, r: SimulationInterface):
        self._base = r
        super().__init__(r._robot_cpu.with_frame(self.T), r.q, r.dq,
                         device=r.device, dtype=r.dtype)
        self.t = r.t

    def _check(self):
        if self._base is None:
            raise RuntimeError(
                "[TransformedSimulationInterface] Object is not initialized")

    def update_kinematics(self):
        self._check()
        # mirror the wrapped robot's state first (cpp:31-46)
        self.q = self._base.q.copy()
        self.dq = self._base.dq.copy()
        self.t = self._base.t
        super().update_kinematics()

    def send_acc(self, dt, ddq, update_kin=True):
        self._check()
        self._base.send_acc(dt, ddq, update_kin)
        self.update_kinematics()

    def send_vel(self, dt, dq, update_kin=True):
        self._check()
        self._base.send_vel(dt, dq, update_kin)
        self.update_kinematics()

    def set_conf(self, q, dq, reset_time=True):
        self._check()
        self._base.set_conf(q, dq, reset_time)
        self.update_kinematics()
        if reset_time:
            self.t = 0.0

    def set_time(self, t):
        self._check()
        self.t = float(t)
        self._base.set_time(t)
