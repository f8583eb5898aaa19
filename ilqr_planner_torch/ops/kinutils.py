"""Kinematics utility operations.

The port's counterpart of the JAX package's `ops/kinutils.py`: the small
utilities the reference keeps next to its serializers (utils.cpp:64-70),
here the mass-weighted Jacobian pseudo-inverse used to map task-space
commands to joint space on a real robot. A library inverse, as the JAX
function uses outside any Pallas kernel.
"""

import torch

__all__ = ["jac_pseudo_inverse"]


def jac_pseudo_inverse(J, Minv=None):
    """Mass-weighted right pseudo-inverse Minv J^T (J Minv J^T)^-1
    (computeJacPseudoInverse, utils.cpp:64-70). With Minv=None the plain
    Moore-Penrose right inverse J^T (J J^T)^-1 is returned. Batched over
    leading axes."""
    Jt = J.transpose(-1, -2)
    if Minv is None:
        return Jt @ torch.linalg.inv(J @ Jt)
    return Minv @ Jt @ torch.linalg.inv(J @ Minv @ Jt)
