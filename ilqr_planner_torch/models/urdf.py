"""URDF -> KinematicChain, parsed on the host at problem-build time.

PyTorch counterpart of the pure-Python half of
the JAX package's `models/urdf.py` (no native parser): the URDF is read with
the standard library XML parser, fixed joints are folded into the next
actuated joint's origin (or the tip transform), and the optional virtual tip
frame (EulerZYX rotation plus translation) is composed into the tip.
"""

import xml.etree.ElementTree as ET

import numpy as np
import torch

from ilqr_planner_torch.models.chain import KinematicChain
from ilqr_planner_torch.ops import so3
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["parse_urdf", "chain_from_urdf"]

_ACTUATED = ("revolute", "continuous", "prismatic")


def _rpy_mat(r, p, y):
    """URDF fixed-axis rpy, R = Rz(y) Ry(p) Rx(r), from host floats to a
    float64 numpy matrix (`so3.rpy_matrix`)."""
    r, p, y = (torch.tensor(float(v), dtype=torch.float64) for v in (r, p, y))
    return so3.rpy_matrix(r, p, y).numpy()


def _vec(attr, default):
    if attr is None:
        return np.array(default, dtype=float)
    return np.array([float(v) for v in attr.split()], dtype=float)


def parse_urdf(urdf: str, base_frame: str, tip_frame: str, is_path: bool = True):
    """The joint path base_frame -> tip_frame as a list of dicts
    {name, type, parent, child, R, p, axis} in base-to-tip order. Raises
    ValueError when no chain connects the two frames."""
    root = ET.parse(urdf).getroot() if is_path else ET.fromstring(urdf)

    child_to_joint = {}
    for j in root.findall("joint"):
        origin = j.find("origin")
        rpy = _vec(origin.get("rpy") if origin is not None else None, [0, 0, 0])
        xyz = _vec(origin.get("xyz") if origin is not None else None, [0, 0, 0])
        axis_el = j.find("axis")
        axis = _vec(axis_el.get("xyz") if axis_el is not None else None, [1, 0, 0])
        info = {
            "name": j.get("name"),
            "type": j.get("type"),
            "parent": j.find("parent").get("link"),
            "child": j.find("child").get("link"),
            "R": _rpy_mat(*rpy),
            "p": xyz,
            "axis": axis,
        }
        child_to_joint[info["child"]] = info

    path = []
    link = tip_frame
    while link != base_frame:
        j = child_to_joint.get(link)
        if j is None:
            raise ValueError(
                f"Unable to build kinematic chain from {base_frame} to {tip_frame}")
        path.append(j)
        link = j["parent"]
    path.reverse()
    return path


def chain_from_urdf(urdf, base_frame: str, tip_frame: str,
                    transform_rpy=(0.0, 0.0, 0.0),
                    transform_xyz=(0.0, 0.0, 0.0), is_path: bool = True,
                    dtype=torch.float64, device=None) -> KinematicChain:
    """Build a KinematicChain from a URDF path (or its text, with
    `is_path=False`), folding fixed joints and the virtual tip frame
    (rotation EulerZYX(rpy) = Rz(rpy[0]) Ry(rpy[1]) Rx(rpy[2]))."""
    path = parse_urdf(str(urdf), base_frame, tip_frame, is_path=is_path)

    origin_rot, origin_pos, axes, prismatic = [], [], [], []
    R_acc = np.eye(3)
    p_acc = np.zeros(3)
    for j in path:
        p_acc = p_acc + R_acc @ j["p"]
        R_acc = R_acc @ j["R"]
        if j["type"] in _ACTUATED:
            origin_rot.append(R_acc)
            origin_pos.append(p_acc)
            axes.append(j["axis"])
            prismatic.append(1.0 if j["type"] == "prismatic" else 0.0)
            R_acc = np.eye(3)
            p_acc = np.zeros(3)
        elif j["type"] != "fixed":
            raise ValueError(f"Unsupported joint type {j['type']!r} ({j['name']})")
    if not axes:
        raise ValueError("Chain has no actuated joints")

    r0, r1, r2 = (float(v) for v in transform_rpy)
    virtual_R = _rpy_mat(r2, r1, r0)  # Rz(r0) Ry(r1) Rx(r2)
    virtual_p = np.array(transform_xyz, dtype=float)
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return KinematicChain(
        origin_rot=t(np.stack(origin_rot)),
        origin_pos=t(np.stack(origin_pos)),
        axis=t(np.stack(axes)),
        prismatic=t(np.array(prismatic)),
        tip_rot=t(R_acc @ virtual_R),
        tip_pos=t(p_acc + R_acc @ virtual_p),
    )
