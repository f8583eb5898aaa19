"""Robot: a kinematic model kind plus an optional object frame.

PyTorch counterpart of the JAX package's `models/robot.py`, chain kind only.
Planar robots and object frames raise until their slice (ROADMAP Queue 1
item 9).
"""

import dataclasses
from typing import Optional

import torch

from ilqr_planner_torch.models.chain import (KinematicChain, chain_fk,
                                             chain_kin)
from ilqr_planner_torch.models.kinstate import KinState

__all__ = ["Robot", "robot_fk", "robot_kin"]

_LATER = ("is not ported yet (ROADMAP Queue 1 item 9: sequential specs, "
          "object frames and the planar robot)")


@dataclasses.dataclass
class Robot:
    """kind: 'chain'. frame: always None in this slice."""

    kind: str
    chain: Optional[KinematicChain] = None
    frame: Optional[torch.Tensor] = None

    @property
    def dof(self) -> int:
        return self.chain.dof

    @property
    def nb_car_dim(self) -> int:
        """3 for spatial chains."""
        return 3

    def with_frame(self, T) -> "Robot":
        raise NotImplementedError(f"object frames {_LATER}")

    @staticmethod
    def from_chain(chain: KinematicChain) -> "Robot":
        return Robot(kind="chain", chain=chain)

    @staticmethod
    def from_planar(planar) -> "Robot":
        raise NotImplementedError(f"the planar robot {_LATER}")


def _chain_only(robot: Robot):
    if robot.kind != "chain":
        raise NotImplementedError(f"robot kind {robot.kind!r} {_LATER}")
    if robot.frame is not None:
        raise NotImplementedError(f"object frames {_LATER}")


def robot_kin(robot: Robot, q, dq) -> KinState:
    """Kinematic state of `robot` at (q, dq), over leading batch axes."""
    _chain_only(robot)
    return chain_kin(robot.chain, q, dq)


def robot_fk(robot: Robot, q):
    """(position [..., 3], quaternion [..., 4]) of the end effector at q: the
    `x` and `quat` of `robot_kin` from the chain walk alone, no Jacobian."""
    _chain_only(robot)
    return chain_fk(robot.chain, q)
