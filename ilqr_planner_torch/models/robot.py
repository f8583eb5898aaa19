"""Robot: a kinematic model kind plus an optional object frame.

PyTorch counterpart of the JAX package's `models/robot.py`, chain kind only.
Planar robots and object frames raise until their slice (ROADMAP Queue 1
item 9).
"""

import dataclasses
from typing import Optional

import torch

from ilqr_planner_torch.models.chain import KinematicChain

__all__ = ["Robot"]

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
