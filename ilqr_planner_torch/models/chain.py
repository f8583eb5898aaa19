"""Serial kinematic chains: forward kinematics and the geometric Jacobian.

PyTorch counterpart of the JAX package's `models/chain.py`. The chain is a
dataclass of tensors (per-actuated-joint origin transforms with the fixed
joints folded in, joint axes, prismatic mask, tip transform); FK and the
Jacobian are functions of q with an optional leading batch. The joint loop
runs in Python over the (small, fixed) number of joints.

Conventions: quaternions are w-first; the geometric Jacobian is 6 x dof with
the linear rows on top, in the base frame, about the chain tip.
"""

import dataclasses

import torch

from ilqr_planner_torch.models.kinstate import KinState
from ilqr_planner_torch.ops import so3

__all__ = ["KinematicChain", "chain_fk", "chain_jacobian", "chain_kin",
           "jacobian_derivative"]


@dataclasses.dataclass
class KinematicChain:
    """Static geometry of an nj-joint serial chain.

    origin_rot: (nj, 3, 3)  rotation of joint i's frame in its parent frame
    origin_pos: (nj, 3)     translation of joint i's frame in its parent frame
    axis:       (nj, 3)     joint axis in the joint's own frame
    prismatic:  (nj,)       1.0 where the joint is prismatic, 0.0 revolute
    tip_rot:    (3, 3)      fixed transform from the last joint to the tip
    tip_pos:    (3,)
    """

    origin_rot: torch.Tensor
    origin_pos: torch.Tensor
    axis: torch.Tensor
    prismatic: torch.Tensor
    tip_rot: torch.Tensor
    tip_pos: torch.Tensor

    @property
    def dof(self) -> int:
        return self.origin_pos.shape[-2]


def _mm3(A, Bm):
    """A [..., 3, 3] @ Bm [..., 3, 3] as one broadcast multiply and a sum
    over the three terms: over a large batch of 3 x 3 products this is a few
    elementwise passes, where a batched matrix product runs one tiny GEMM a
    state."""
    return (A[..., :, :, None] * Bm[..., None, :, :]).sum(-2)


def _frames(chain: KinematicChain, q):
    """Walk the chain: (p_ee [..., 3], R_ee [..., 3, 3], z [..., nj, 3] world
    joint axes, o [..., nj, 3] world joint origins)."""
    batch = q.shape[:-1]
    R = torch.eye(3, dtype=q.dtype, device=q.device).expand(*batch, 3, 3)
    p = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    zs, os_ = [], []
    for i in range(chain.dof):
        p = p + R @ chain.origin_pos[i]
        R = R @ chain.origin_rot[i]
        z = R @ chain.axis[i]
        prism = chain.prismatic[i]
        # branchless revolute/prismatic: rotate by q (1 - prism), translate
        # by q prism
        R = _mm3(R, so3.axis_angle(chain.axis[i], q[..., i] * (1.0 - prism)))
        p = p + z * (q[..., i] * prism)[..., None]
        zs.append(z)
        os_.append(p)
    p_ee = p + R @ chain.tip_pos
    R_ee = R @ chain.tip_rot
    return p_ee, R_ee, torch.stack(zs, dim=-2), torch.stack(os_, dim=-2)


def chain_fk(chain: KinematicChain, q):
    """Forward kinematics: (EE position [..., 3], quaternion [..., 4])."""
    p_ee, R_ee, _, _ = _frames(chain, q)
    return p_ee, so3.mat_to_quat(R_ee)


def chain_jacobian(chain: KinematicChain, q):
    """(p_ee, R_ee, J [..., 6, dof]) from one chain walk. Revolute column i:
    Jv = z_i x (p_ee - o_i), Jw = z_i; prismatic: Jv = z_i, Jw = 0."""
    p_ee, R_ee, z, o = _frames(chain, q)
    prism = chain.prismatic[:, None] > 0
    Jv = torch.where(prism, z, torch.linalg.cross(z, p_ee[..., None, :] - o))
    Jw = torch.where(prism, torch.zeros_like(z), z)
    J = torch.cat([Jv.transpose(-1, -2), Jw.transpose(-1, -2)], dim=-2)
    return p_ee, R_ee, J


def jacobian_derivative(J, dq):
    """dJ/dt [..., 6, dof] of the geometric Jacobian J [..., 6, dof] along
    dq [..., dof], from its cross-product structure. For column i and
    joint j:
      j <  i: dJv_i/dq_j = Jw_j x Jv_i,  dJw_i/dq_j = Jw_j x Jw_i
      j == i: dJv_i/dq_i = Jw_i x Jv_i,  dJw_i/dq_i = 0
      j >  i: dJv_i/dq_j = Jw_i x Jv_j,  dJw_i/dq_j = 0
    A prismatic column has Jw = 0, which zeroes exactly the terms that must
    vanish, so the formulas hold for prismatic joints too."""
    dof = J.shape[-1]
    Jv = J[..., :3, :].transpose(-1, -2)  # [..., dof, 3] columns
    Jw = J[..., 3:, :].transpose(-1, -2)
    cross = torch.linalg.cross
    # pairwise cross products, [..., j, i, 3]
    lin_le = cross(Jw[..., :, None, :], Jv[..., None, :, :], dim=-1)
    ang_lt = cross(Jw[..., :, None, :], Jw[..., None, :, :], dim=-1)
    lin_gt = cross(Jw[..., None, :, :], Jv[..., :, None, :], dim=-1)
    idx = torch.arange(dof, device=J.device)
    le = (idx[:, None] <= idx[None, :])[..., None]
    lt = (idx[:, None] < idx[None, :])[..., None]
    lin = torch.where(le, lin_le, lin_gt)
    ang = torch.where(lt, ang_lt, torch.zeros_like(ang_lt))
    dJv = torch.einsum("...jic,...j->...ci", lin, dq)
    dJw = torch.einsum("...jic,...j->...ci", ang, dq)
    return torch.cat([dJv, dJw], dim=-2)


def chain_kin(chain: KinematicChain, q, dq, with_dJ: bool = True) -> KinState:
    """Full kinematic state at (q, dq); `with_dJ=False` leaves dJ None (the
    system functions never read it, and it costs dof^2 cross products a
    state)."""
    p_ee, R_ee, J = chain_jacobian(chain, q)
    dx = (J[..., :3, :] @ dq[..., None])[..., 0]
    w = (J[..., 3:, :] @ dq[..., None])[..., 0]
    return KinState(x=p_ee, dx=dx, quat=so3.mat_to_quat(R_ee), w=w, J=J,
                    dJ=jacobian_derivative(J, dq) if with_dJ else None)
