"""End-effector kinematic state as a dataclass of tensors.

PyTorch counterpart of the JAX package's `models/kinstate.py`. The object-frame
transform (`transform_kin`) comes with object frames in a later slice.
"""

import dataclasses
from typing import Optional

import torch

__all__ = ["KinState"]


@dataclasses.dataclass
class KinState:
    """End-effector kinematic quantities at one configuration.

    x:    (..., 3)       EE position
    dx:   (..., 3)       EE linear velocity, Jt @ dq
    quat: (..., 4)       EE orientation quaternion, w-first
    w:    (..., 3)       EE angular velocity, Jr @ dq
    J:    (..., 6, dof)  geometric Jacobian [Jt; Jr]
    dJ:   (..., 6, dof)  time derivative of J; None until the second-order
                         slice ports `jacobian_derivative` (ROADMAP S2.4)
    """

    x: torch.Tensor
    dx: torch.Tensor
    quat: torch.Tensor
    w: torch.Tensor
    J: torch.Tensor
    dJ: Optional[torch.Tensor] = None
