"""Plain forward kinematics of a serial chain read from a URDF file.

Batch-first PyTorch: a configuration q is [B, dof], a rotation [B, 3, 3].
Every matrix product goes through `mm`, so the control run can round its
operands to TF32 (`precision.Precision`). Imports nothing of the program.
"""

import math
import xml.etree.ElementTree as ET

import torch


def _rpy_matrix(rpy):
    """URDF origin rotation: Rz(yaw) Ry(pitch) Rx(roll), as nested lists."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p),
                              math.sin(p), math.cos(y), math.sin(y))
    return [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]


def read_chain(urdf_path, base, tip):
    """The joints from `base` to `tip` -> list of dicts (type, xyz, R, axis),
    in order from the base."""
    root = ET.parse(urdf_path).getroot()
    by_child = {j.find("child").get("link"): j for j in root.findall("joint")}
    joints, link = [], tip
    while link != base:
        j = by_child[link]
        origin = j.find("origin")
        xyz = [float(v) for v in (origin.get("xyz", "0 0 0") if origin is not None
                                  else "0 0 0").split()]
        rpy = [float(v) for v in (origin.get("rpy", "0 0 0") if origin is not None
                                  else "0 0 0").split()]
        axis = j.find("axis")
        joints.append({"type": j.get("type"), "xyz": xyz, "R": _rpy_matrix(rpy),
                       "axis": [float(v) for v in axis.get("xyz").split()]
                       if axis is not None else [0.0, 0.0, 1.0]})
        link = j.find("parent").get("link")
    return joints[::-1]


class Chain:
    """A serial chain of revolute and fixed joints on a device, in a dtype."""

    def __init__(self, urdf_path, base, tip, prec):
        self.prec = prec
        self.joints = []
        for j in read_chain(urdf_path, base, tip):
            if j["type"] not in ("revolute", "continuous", "fixed"):
                raise ValueError(f"joint type {j['type']} is not modelled")
            self.joints.append({"fixed": j["type"] == "fixed",
                                "p": prec.tensor(j["xyz"]),
                                "R": prec.tensor(j["R"]),
                                "axis": prec.tensor(j["axis"])})
        self.dof = sum(not j["fixed"] for j in self.joints)

    def fk(self, q, jacobian=False):
        """q [B, dof] -> (p [B, 3], R [B, 3, 3], J [B, 6, dof] or None): the
        tip's pose in the base frame and its geometric Jacobian (linear rows
        first)."""
        mm = self.prec.mm
        B = q.shape[0]
        R = torch.eye(3, dtype=q.dtype, device=q.device).expand(B, 3, 3)
        p = torch.zeros(B, 3, dtype=q.dtype, device=q.device)
        axes, origins = [], []
        i = 0
        for j in self.joints:
            p = p + mm(R, j["p"][None, :, None].expand(B, 3, 1))[..., 0]
            R = mm(R, j["R"].expand(B, 3, 3))
            if j["fixed"]:
                continue
            a = j["axis"]
            z = mm(R, a[None, :, None].expand(B, 3, 1))[..., 0]
            axes.append(z)
            origins.append(p)
            R = mm(R, _axis_angle(a, q[:, i]))
            i += 1
        J = None
        if jacobian:
            cols = [torch.cat([torch.linalg.cross(z, p - o, dim=-1), z], dim=-1)
                    for z, o in zip(axes, origins)]
            J = torch.stack(cols, dim=-1)
        return p, R, J


def _axis_angle(a, theta):
    """Rotation about the unit axis a [3] by theta [B] -> [B, 3, 3]
    (Rodrigues)."""
    K = torch.zeros(3, 3, dtype=theta.dtype, device=theta.device)
    K[0, 1], K[0, 2], K[1, 2] = -a[2], a[1], -a[0]
    K = K - K.T
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotation_to_quaternion(R):
    """[B, 3, 3] -> unit quaternions [B, 4], w first (either sign)."""
    m = R
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                     m[:, 1, 0] - m[:, 0, 1]], -1),
        torch.stack([m[:, 2, 1] - m[:, 1, 2], 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0]], -1),
        torch.stack([m[:, 0, 2] - m[:, 2, 0], m[:, 0, 1] + m[:, 1, 0],
                     1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], m[:, 1, 2] + m[:, 2, 1]], -1),
        torch.stack([m[:, 1, 0] - m[:, 0, 1], m[:, 0, 2] + m[:, 2, 0],
                     m[:, 1, 2] + m[:, 2, 1], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1),
    ], 1)                                                   # [B, 4 candidates, 4]
    diag = torch.stack([1 + tr, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                        1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                        1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    best = diag.argmax(-1)
    q = cands[torch.arange(R.shape[0], device=R.device), best]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
