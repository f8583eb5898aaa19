"""Robot: a kinematic model kind plus an optional object frame.

PyTorch counterpart of the JAX package's `models/robot.py`. The system
functions see one entry point, `robot_kin(robot, q, dq)` (and the Jacobian-
free `robot_fk`), which dispatches on the kind ('chain' or 'planar') and
expresses the end-effector quantities in the object frame when one is set.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ilqr_planner_torch.models.chain import (KinematicChain, chain_fk,
                                             chain_kin)
from ilqr_planner_torch.models.kinstate import KinState, transform_kin
from ilqr_planner_torch.models.planar import PlanarRobot, planar_fk, planar_kin
from ilqr_planner_torch.ops import so3

__all__ = ["Robot", "robot_fk", "robot_kin"]


@dataclasses.dataclass
class Robot:
    """kind: 'chain' | 'planar'. frame: an optional 4 x 4 object frame T
    (chains only); when set, every end-effector quantity is expressed in
    that frame."""

    kind: str
    chain: Optional[KinematicChain] = None
    planar: Optional[PlanarRobot] = None
    frame: Optional[torch.Tensor] = None

    @property
    def dof(self) -> int:
        return self.chain.dof if self.kind == "chain" else self.planar.dof

    @property
    def nb_car_dim(self) -> int:
        """3 for spatial chains, 2 for planar robots."""
        return 3 if self.kind == "chain" else 2

    def tensors(self) -> dict:
        """Every tensor of the robot by name ('chain.*', 'planar.*',
        'frame')."""
        out = {}
        for part in ("chain", "planar"):
            obj = getattr(self, part)
            if obj is not None:
                out.update({f"{part}.{f.name}": getattr(obj, f.name)
                            for f in dataclasses.fields(obj)})
        if self.frame is not None:
            out["frame"] = self.frame
        return out

    def to(self, device, dtype=None) -> "Robot":
        """The same robot with every tensor on `device` (and in `dtype`
        when given)."""
        def move(obj):
            if obj is None:
                return None
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(device=device, dtype=dtype)
                for f in dataclasses.fields(obj)})
        return Robot(kind=self.kind, chain=move(self.chain),
                     planar=move(self.planar),
                     frame=None if self.frame is None
                     else self.frame.to(device=device, dtype=dtype))

    def with_frame(self, T) -> "Robot":
        """The robot with its end effector expressed in the object frame T
        (4 x 4), in the chain's dtype and on its device."""
        if self.kind == "planar":
            # a 4 x 4 spatial frame cannot transform the planar robot's 2-D
            # positions and 4 x dof Jacobian: fail here, not at solve time
            raise ValueError(
                "object frames require a 3-D (chain) robot; planar robots "
                "have 2-D positions and 4 x dof Jacobians that a 4x4 "
                "spatial frame cannot transform")
        ref = self.chain.origin_pos
        T = torch.as_tensor(np.array(T, dtype=np.float64), dtype=ref.dtype,
                            device=ref.device)
        return dataclasses.replace(self, frame=T)

    @staticmethod
    def from_chain(chain: KinematicChain) -> "Robot":
        return Robot(kind="chain", chain=chain)

    @staticmethod
    def from_planar(planar: PlanarRobot) -> "Robot":
        return Robot(kind="planar", planar=planar)


def robot_kin(robot: Robot, q, dq, with_dJ: bool = True) -> KinState:
    """Kinematic state of `robot` at (q, dq), over leading batch axes, in
    its object frame when one is set. `with_dJ=False` skips dJ."""
    if robot.kind == "chain":
        ks = chain_kin(robot.chain, q, dq, with_dJ)
    elif robot.kind == "planar":
        ks = planar_kin(robot.planar, q, dq, with_dJ)
    else:
        raise ValueError(f"unknown robot kind {robot.kind!r}")
    if robot.frame is not None:
        ks = transform_kin(robot.frame, ks)
    return ks


def robot_fk(robot: Robot, q):
    """(position [..., c], quaternion [..., 4]) of the end effector at q:
    the `x` and `quat` of `robot_kin`, bit for bit, without the Jacobian."""
    if robot.kind == "planar":
        x = planar_fk(robot.planar, q)
        quat = q.new_zeros(*q.shape[:-1], 4)
        quat[..., 0] = 1.0
        return x, quat
    if robot.kind != "chain":
        raise ValueError(f"unknown robot kind {robot.kind!r}")
    p, quat = chain_fk(robot.chain, q)
    if robot.frame is not None:
        R, t = robot.frame[:3, :3], robot.frame[:3, 3]
        p = (p - t) @ R
        quat = so3.mat_to_quat(R.transpose(-1, -2) @ so3.quat_to_mat(quat))
    return p, quat
