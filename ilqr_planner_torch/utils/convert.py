"""Carry parameters across from numpy arrays.

A test pulls the arrays out of a JAX `KinematicChain`, `PlanarRobot`, robot
frame, `Spec` or `Constraints` with `np.asarray` and builds the port's
counterpart here, so both packages compute on exactly the same constants
without the port importing JAX.
"""

import numpy as np
import torch

from ilqr_planner_torch.models.chain import KinematicChain
from ilqr_planner_torch.models.planar import PlanarRobot
from ilqr_planner_torch.models.robot import Robot
from ilqr_planner_torch.solvers.al_ilqr import Constraints
from ilqr_planner_torch.systems.spec import Spec
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["chain_from_arrays", "robot_from_arrays", "spec_from_arrays",
           "spec_like", "constraints_like"]

_STATIC = ("kind", "nb_deriv", "horizon", "limits_set")


def _tensor(a, dtype, dev):
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=dev)


def chain_from_arrays(origin_rot, origin_pos, axis, prismatic, tip_rot,
                      tip_pos, *, dtype=torch.float64, device=None) -> KinematicChain:
    """A KinematicChain from its six arrays."""
    dev = resolve_device(device)
    return KinematicChain(*(_tensor(a, dtype, dev) for a in (
        origin_rot, origin_pos, axis, prismatic, tip_rot, tip_pos)))


def robot_from_arrays(kind: str, *, chain=None, lengths=None, frame=None,
                      dtype=torch.float64, device=None) -> Robot:
    """A Robot of `kind` 'chain' (from `chain`, the six arrays of
    `chain_from_arrays` in order) or 'planar' (from its link `lengths`),
    with the optional 4 x 4 object `frame`, every array in `dtype`."""
    dev = resolve_device(device)
    if kind == "chain":
        robot = Robot.from_chain(chain_from_arrays(*chain, dtype=dtype,
                                                   device=dev))
    elif kind == "planar":
        robot = Robot.from_planar(PlanarRobot(_tensor(lengths, dtype, dev)))
    else:
        raise ValueError(f"unknown robot kind {kind!r}")
    return robot if frame is None else robot.with_frame(frame)


def spec_from_arrays(fields: dict, robot: Robot = None, *, subs=(),
                     device=None) -> Spec:
    """A Spec from {name: value}: the static fields (kind, nb_deriv,
    horizon, limits_set) as Python values, every other field as an array
    whose dtype it keeps. The robot (chain or planar, with its frame) moves
    to the same device; a sequential spec takes its subsystems' Specs as
    `subs`."""
    dev = resolve_device(device)
    kw = {k: fields[k] for k in _STATIC}
    for k, v in fields.items():
        if k not in _STATIC and v is not None:
            kw[k] = _tensor(v, None, dev)
    return Spec(robot=None if robot is None else robot.to(dev),
                subs=tuple(subs), **kw)


_CHAIN_FIELDS = ("origin_rot", "origin_pos", "axis", "prismatic", "tip_rot",
                 "tip_pos")
_LEAVES = ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
           "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
           "dq0")


def spec_like(src, *, device=None) -> Spec:
    """A Spec with the content of `src`, any object with a Spec's attribute
    names (a JAX package Spec, say): the static fields as they are, every
    array through `np.asarray` in its own dtype, the robot (chain or planar,
    with its frame) and the subsystems of a sequential spec likewise."""
    dev = resolve_device(device)
    robot = None
    if getattr(src, "robot", None) is not None:
        r = src.robot
        if r.kind == "chain":
            arrays = [np.asarray(getattr(r.chain, f)) for f in _CHAIN_FIELDS]
            kw = {"chain": arrays}
        else:
            arrays = [np.asarray(r.planar.lengths)]
            kw = {"lengths": arrays[0]}
        dtype = getattr(torch, str(arrays[0].dtype))
        frame = None if r.frame is None else np.asarray(r.frame)
        robot = robot_from_arrays(r.kind, frame=frame, dtype=dtype, device=dev,
                                  **kw)
    fields = {k: getattr(src, k) for k in _STATIC}
    fields.update({k: None if getattr(src, k, None) is None
                   else np.asarray(getattr(src, k)) for k in _LEAVES})
    subs = [spec_like(s, device=dev) for s in getattr(src, "subs", ())]
    return spec_from_arrays(fields, robot, subs=subs, device=dev)


def constraints_like(src, *, device=None) -> Constraints:
    """Constraints with the content of `src`, any object with the attributes
    A and b (a JAX package Constraints, say), each array in its own dtype."""
    dev = resolve_device(device)
    return Constraints(A=_tensor(np.asarray(src.A), None, dev),
                       b=_tensor(np.asarray(src.b), None, dev))
