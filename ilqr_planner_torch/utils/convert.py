"""Carry parameters across from numpy arrays.

A test pulls the arrays out of a JAX `KinematicChain` or `Spec` with
`np.asarray` and builds the port's counterpart here, so both packages
compute on exactly the same constants without the port importing JAX.
"""

import dataclasses

import numpy as np
import torch

from ilqr_planner_torch.models.chain import KinematicChain
from ilqr_planner_torch.models.robot import Robot
from ilqr_planner_torch.systems.spec import Spec
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["chain_from_arrays", "spec_from_arrays"]

_STATIC = ("kind", "nb_deriv", "horizon", "limits_set")


def _tensor(a, dtype, dev):
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=dev)


def chain_from_arrays(origin_rot, origin_pos, axis, prismatic, tip_rot,
                      tip_pos, *, dtype=torch.float64, device=None) -> KinematicChain:
    """A KinematicChain from its six arrays."""
    dev = resolve_device(device)
    return KinematicChain(*(_tensor(a, dtype, dev) for a in (
        origin_rot, origin_pos, axis, prismatic, tip_rot, tip_pos)))


def spec_from_arrays(fields: dict, robot: Robot, *, device=None) -> Spec:
    """A Spec from {name: value}: the static fields (kind, nb_deriv,
    horizon, limits_set) as Python values, every other field as an array
    whose dtype it keeps. The robot's chain moves to the same device."""
    dev = resolve_device(device)
    chain = robot.chain
    robot = dataclasses.replace(robot, chain=dataclasses.replace(
        chain, **{f.name: getattr(chain, f.name).to(dev)
                  for f in dataclasses.fields(chain)}))
    kw = {k: fields[k] for k in _STATIC}
    for k, v in fields.items():
        if k not in _STATIC and v is not None:
            kw[k] = _tensor(v, None, dev)
    return Spec(robot=robot, **kw)
