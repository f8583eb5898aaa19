"""S^d unit-sphere (S^3 quaternion) manifold operations, branchless.

PyTorch counterpart of the JAX package's `ops/sd.py`. Every guard (zero
inputs, coincident bases, the dot-product clamp, the hemisphere flip) is a
`torch.where` select, and every division runs over a guarded denominator, so
the branch a select discards holds no NaN or inf. Operations broadcast over
leading batch axes; the manifold dimension is the trailing axis.

Numerics kept:
  * `distance` clamps the raw dot product to [-1, 1] before the arccos and
    subtracts pi when the dot is negative (hemisphere flip), which makes the
    quaternion log map sign-invariant (q and -q give the same residual).
  * `log_map` returns zero when either input is exactly zero or when the
    projected tangent has zero norm.
  * `transport` returns `v` unchanged when either base is zero or the
    squared geodesic distance is zero.
"""

import math

import torch

__all__ = [
    "to_unit_norm",
    "dquat_to_dx_jac",
    "exp_map",
    "distance",
    "log_map",
    "transport",
    "quat_rate",
]


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def _is_zero(x):
    """Exact all-zero test."""
    return (x == 0).all(-1)


def _guarded(d):
    """d where it is positive, else 1: a denominator that is never zero."""
    return torch.where(d > 0, d, torch.ones_like(d))


def to_unit_norm(x):
    """Normalize to unit norm, guarded against zero input."""
    return x / _guarded(_norm(x))[..., None]


def dquat_to_dx_jac(q):
    """The 3x4 map E(q) from quaternion rate to angular velocity.

    Quaternion layout is w-first: q = [w, x, y, z]. Broadcasts over leading
    axes, returning shape (..., 3, 4).
    """
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack([-x, w, -z, y], dim=-1)
    row1 = torch.stack([-y, z, w, -x], dim=-1)
    row2 = torch.stack([-z, -y, x, w], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def exp_map(base, u):
    """Map tangent vector `u` at `base` onto the sphere."""
    b = to_unit_norm(base)
    nu = _norm(u)
    safe = _guarded(nu)[..., None]
    mapped = to_unit_norm(b * torch.cos(nu)[..., None]
                          + u * torch.sin(nu)[..., None] / safe)
    return torch.where((nu == 0)[..., None], b.expand_as(mapped), mapped)


def distance(x, y):
    """Signed geodesic distance with hemisphere flip: the raw dot product
    (no normalization), clamped to [-1, 1]; when it is negative the arccos
    is shifted by -pi."""
    d = torch.clamp((x * y).sum(-1), -1.0, 1.0)
    ac = torch.arccos(d)
    return torch.where(d < 0, ac - math.pi, ac)


def log_map(base, y):
    """Project sphere point `y` into the tangent space of `base`."""
    degenerate = _is_zero(base) | _is_zero(y)
    b = to_unit_norm(base)
    yn = to_unit_norm(y)
    temp = yn - (b * yn).sum(-1, keepdim=True) * b
    tn = _norm(temp)
    out = distance(b, yn)[..., None] * temp / _guarded(tn)[..., None]
    out = torch.where((tn == 0)[..., None], torch.zeros_like(out), out)
    return torch.where(degenerate[..., None], torch.zeros_like(out), out)


def transport(v, base1, base2):
    """Parallel-transport tangent `v` from `base1`'s to `base2`'s tangent
    space, with the degenerate-case passthroughs."""
    degenerate = _is_zero(base1) | _is_zero(base2)
    d2 = distance(base1, base2) ** 2
    l12 = log_map(base1, base2)
    l21 = log_map(base2, base1)
    coef = (l12 * v).sum(-1) / _guarded(d2)
    out = v - coef[..., None] * (l12 + l21)
    out = torch.where((d2 == 0)[..., None], v.expand_as(out), out)
    return torch.where(degenerate[..., None], v.expand_as(out), out)


def quat_rate(quat, w):
    """Quaternion rate 0.5 * E(q)^T * omega."""
    E = dquat_to_dx_jac(quat)
    return 0.5 * (E * w[..., :, None]).sum(-2)
