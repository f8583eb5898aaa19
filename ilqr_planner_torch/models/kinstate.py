"""End-effector kinematic state as a dataclass of tensors, and its transform
into an object frame.

PyTorch counterpart of the JAX package's `models/kinstate.py`. Expressing the
end-effector quantities in an object frame T is a function of the kinematic
state (`transform_kin`), not a wrapper object.
"""

import dataclasses
from typing import Optional

import torch

from ilqr_planner_torch.ops import so3

__all__ = ["KinState", "transform_kin"]


@dataclasses.dataclass
class KinState:
    """End-effector kinematic quantities at one configuration.

    x:    (..., c)        EE position (c = 3 for chains, 2 planar)
    dx:   (..., c)        EE linear velocity, Jt @ dq
    quat: (..., 4)        EE orientation quaternion, w-first
    w:    (..., c)        EE angular velocity, Jr @ dq
    J:    (..., 2c, dof)  geometric Jacobian [Jt; Jr]
    dJ:   (..., 2c, dof)  time derivative of J
    """

    x: torch.Tensor
    dx: torch.Tensor
    quat: torch.Tensor
    w: torch.Tensor
    J: torch.Tensor
    dJ: Optional[torch.Tensor] = None


def transform_kin(T, ks: KinState) -> KinState:
    """Express a 3-D kinematic state in the object frame T (a 4 x 4
    homogeneous transform, rotation R, origin p):
      J'  = blockdiag(R, R)^T J,  dJ' likewise,
      x'  = R^T (x - p),  dx' = R^T dx,  w' = R^T w,
      q'  = the quaternion of R^T R(q).
    A state without dJ keeps none.
    """
    R = T[:3, :3]
    p = T[:3, 3]
    Rt = R.transpose(-1, -2)
    x = (ks.x - p) @ R          # R^T v written as v R over the leading axes
    dx = ks.dx @ R
    w = ks.w @ R
    quat = so3.mat_to_quat(Rt @ so3.quat_to_mat(ks.quat))
    J = torch.cat([Rt @ ks.J[..., :3, :], Rt @ ks.J[..., 3:, :]], dim=-2)
    dJ = (None if ks.dJ is None else
          torch.cat([Rt @ ks.dJ[..., :3, :], Rt @ ks.dJ[..., 3:, :]], dim=-2))
    return KinState(x=x, dx=dx, quat=quat, w=w, J=J, dJ=dJ)
