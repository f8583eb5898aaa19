"""SO(3) utilities: rotation constructors and robust quaternion extraction.

PyTorch counterpart of the JAX package's `ops/so3.py`. Quaternions are
w-first: [w, x, y, z]. Layouts follow the JAX functions: a leading batch,
the 3 x 3 or 4 on the trailing axes; the axis rotations take an angle
tensor of any shape (...) and return (..., 3, 3), a scalar angle one
matrix as in the JAX package.
"""

import torch

__all__ = [
    "rot_x",
    "rot_y",
    "rot_z",
    "rpy_matrix",
    "euler_zyx",
    "axis_angle",
    "mat_to_quat",
    "quat_to_mat",
    "cross",
]


def _mat3(rows):
    """Nine (...) tensors, row by row -> (..., 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _cos_sin(a):
    a = torch.as_tensor(a)
    if not a.is_floating_point():
        a = a.to(torch.get_default_dtype())
    c, s = torch.cos(a), torch.sin(a)
    return c, s, torch.ones_like(c), torch.zeros_like(c)


def rot_x(a):
    """Rotation matrix about the x axis by angle a (radians)."""
    c, s, one, zero = _cos_sin(a)
    return _mat3([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(a):
    """Rotation matrix about the y axis by angle a (radians)."""
    c, s, one, zero = _cos_sin(a)
    return _mat3([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(a):
    """Rotation matrix about the z axis by angle a (radians)."""
    c, s, one, zero = _cos_sin(a)
    return _mat3([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def rpy_matrix(r, p, y):
    """URDF fixed-axis roll/pitch/yaw: R = Rz(y) @ Ry(p) @ Rx(r)."""
    return rot_z(y) @ rot_y(p) @ rot_x(r)


def euler_zyx(alpha, beta, gamma):
    """KDL Rotation::EulerZYX(a, b, g) = Rz(a) @ Ry(b) @ Rx(g), the virtual
    tip frame's rotation (its rpy vector in order [0], [1], [2])."""
    return rot_z(alpha) @ rot_y(beta) @ rot_x(gamma)


def cross(a, b):
    """Cross product over the trailing axis (broadcasting)."""
    a, b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b))
    return torch.linalg.cross(a, b, dim=-1)


def axis_angle(axis, theta):
    """Rodrigues rotation about unit `axis` (..., 3) by angle `theta` (...).

    Returns (..., 3, 3): I + sin(theta) K + (1 - cos(theta)) K^2.
    """
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def quat_to_mat(q):
    """Quaternion [w, x, y, z] (..., 4) to rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mat_to_quat(R):
    """Rotation matrix (..., 3, 3) to quaternion [w, x, y, z], branchless
    Shepperd: all four candidate extractions are formed and the one with the
    largest radicand is kept (the first on a tie, as `jnp.argmax` picks).
    The radicands are floored at 1e-30, the zero guard of the JAX function.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0]
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1]
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2]
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3]

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([torch.stack(c, dim=-1) for c in (q0, q1, q2, q3)],
                        dim=-2)                                  # (..., 4, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
