"""Planar n-link robot.

PyTorch counterpart of the JAX package's `models/planar.py`. Details kept as
the reference has them:
  * forward kinematics uses absolute joint angles,
    x = sum_i l_i [cos q_i, sin q_i], not cumulative ones;
  * the Jacobian is a forward difference with step pi * 1e-3, not the
    analytic derivative;
  * J is 4 x dof with zero rotational rows, and the orientation quaternion
    is the identity.
"""

import dataclasses
import math

import torch

from ilqr_planner_torch.models.kinstate import KinState

__all__ = ["PlanarRobot", "planar_fk", "planar_jacobian", "planar_kin"]

FD_STEP = math.pi * 1e-3  # the forward-difference step of the Jacobian


@dataclasses.dataclass
class PlanarRobot:
    """lengths: (dof,) link lengths."""

    lengths: torch.Tensor

    @property
    def dof(self) -> int:
        return self.lengths.shape[-1]


def planar_fk(robot: PlanarRobot, q):
    """EE position [..., 2]: x = sum_i l_i [cos q_i, sin q_i]."""
    x = (robot.lengths * torch.cos(q)).sum(-1)
    y = (robot.lengths * torch.sin(q)).sum(-1)
    return torch.stack([x, y], dim=-1)


def planar_jacobian(robot: PlanarRobot, q):
    """Forward-difference 2 x dof position Jacobian [..., 2, dof], step
    pi * 1e-3."""
    base = planar_fk(robot, q)
    eye = torch.eye(robot.dof, dtype=q.dtype, device=q.device)
    cols = [(planar_fk(robot, q + FD_STEP * eye[i]) - base) / FD_STEP
            for i in range(robot.dof)]
    return torch.stack(cols, dim=-1)


def planar_kin(robot: PlanarRobot, q, dq, with_dJ: bool = True) -> KinState:
    """Kinematic state: identity quaternion, zero rotational rows, dJ = 0
    (None with `with_dJ=False`)."""
    x = planar_fk(robot, q)
    Jt = planar_jacobian(robot, q)
    J = torch.cat([Jt, torch.zeros_like(Jt)], dim=-2)
    quat = q.new_zeros(*q.shape[:-1], 4)
    quat[..., 0] = 1.0
    dx = (Jt @ dq[..., None])[..., 0]
    return KinState(x=x, dx=dx, quat=quat, w=torch.zeros_like(dx), J=J,
                    dJ=torch.zeros_like(J) if with_dJ else None)
