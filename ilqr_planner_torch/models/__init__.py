"""Robot models: kinematic chains from URDF, the planar n-link robot, FK,
the geometric Jacobian and its time derivative, object frames.

`PANDA_URDF` is the path of the Franka Emika Panda arm shipped with the
package (`panda_link0` -> `panda_tip`).
"""

from pathlib import Path

from ilqr_planner_torch.models.chain import (KinematicChain, chain_fk,
                                             chain_jacobian, chain_kin,
                                             jacobian_derivative)
from ilqr_planner_torch.models.kinstate import KinState, transform_kin
from ilqr_planner_torch.models.planar import (PlanarRobot, planar_fk,
                                              planar_jacobian, planar_kin)
from ilqr_planner_torch.models.robot import Robot, robot_fk, robot_kin
from ilqr_planner_torch.models.urdf import chain_from_urdf, parse_urdf

PANDA_URDF = Path(__file__).resolve().parent / "data" / "panda.urdf"

__all__ = [
    "KinematicChain",
    "KinState",
    "PANDA_URDF",
    "PlanarRobot",
    "Robot",
    "chain_fk",
    "chain_from_urdf",
    "chain_jacobian",
    "chain_kin",
    "jacobian_derivative",
    "parse_urdf",
    "planar_fk",
    "planar_jacobian",
    "planar_kin",
    "robot_fk",
    "robot_kin",
    "transform_kin",
]
