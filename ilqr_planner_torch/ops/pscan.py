"""Parallel-prefix (associative-scan) LQR machinery.

PyTorch counterpart of the JAX package's `ops/pscan.py`. The LQR backward
pass is a sequential H-step recursion; expressed as an associative
combination of per-step "conditional value function" elements it runs in
O(log H) dependent steps.

Formulation: the minimal cost to travel from state x at step i to state z
at step j is

    V_{i->j}(x, z) = 1/2 x^T J x - eta^T x
                     + 1/2 (z - A x - b)^T C^+ (z - A x - b)

with element e = (A, b, C, eta, J). Eliminating the intermediate state
couples two adjacent elements associatively (`combine_cvf`); a reverse
associative scan over [e_0, ..., e_{H-2}, e_terminal] yields every
cost-to-go V_k(x) = 1/2 x^T J_k x - eta_k^T x at once. C is only used
through solves of (I + C J), so a singular C (the terminal element's zeros)
is fine.

A one-step element for dynamics x' = A_k x + B_k u and stage cost
1/2 u^T R u + l_u^T u + 1/2 x^T l_xx x + l_x^T x is
A = A_k, b = -B_k R^{-1} l_u, C = B_k R^{-1} B_k^T, eta = -l_x, J = l_xx;
the terminal element is (0, 0, 0, -lN_x, lN_xx).

`associative_scan` is the port's own copy of the algorithm of
`jax.lax.associative_scan` (the odd/even recursion, `reverse` by flipping
before and after), so the combination tree, and with it the rounding, is
the JAX package's. Batch axes may lead the scan axis.
"""

import torch

from ilqr_planner_torch.ops.linalg import solve_ge

__all__ = ["associative_scan", "combine_cvf", "lqr_cost_to_go",
           "affine_suffix"]


def _mT(a):
    return a.transpose(-1, -2)


def _slice(elems, axis, start, stop=None, step=1):
    idx = (slice(None),) * axis + (slice(start, stop, step),)
    return [e[idx] for e in elems]


def _interleave(a, b, axis):
    """a at the even positions, b at the odd ones of `axis`
    (len(a) = len(b) or len(b) + 1)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    out[(slice(None),) * axis + (slice(0, None, 2),)] = a
    out[(slice(None),) * axis + (slice(1, None, 2),)] = b
    return out


def associative_scan(fn, elems, reverse: bool = False, axis: int = 0):
    """Inclusive scan of the associative `fn(a, b)` over `axis` of each
    tensor of the tuple `elems`: result k combines elements 0..k (with
    `reverse`, elements k..end, folded from the last). The recursion of
    `jax.lax.associative_scan`: combine adjacent pairs, scan the half-size
    sequence recursively (the odd results), combine each odd result with
    the next even element (the even results), interleave."""
    elems = list(elems)
    if reverse:
        elems = [e.flip(axis) for e in elems]

    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = combine(_slice(elems, axis, 0, -1, 2),
                          _slice(elems, axis, 1, None, 2))
        odd = scan(reduced)
        rest = _slice(elems, axis, 2, None, 2)
        if rest[0].shape[axis] == 0:
            even = rest
        elif n % 2 == 0:
            even = combine(_slice(odd, axis, 0, -1), rest)
        else:
            even = combine(odd, rest)
        even = [torch.cat([e0, r], dim=axis)
                for e0, r in zip(_slice(elems, axis, 0, 1), even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    out = scan(elems)
    if reverse:
        out = [e.flip(axis) for e in out]
    return tuple(out)


def combine_cvf(e1, e2):
    """Associative combination of conditional-value-function elements.

    e1 spans the EARLIER interval (i->j), e2 the later (j->l); both are
    tuples (A, b, C, eta, J) with matching batch axes in front.
    """
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    eye = torch.eye(nx, dtype=A1.dtype, device=A1.device)
    # (I + C1 J2)^{-1}, shared by the A/b/C updates; its transpose-inverse
    # (I + J2 C1)^{-1} drives eta/J (C, J symmetric).
    M = solve_ge(eye + C1 @ J2, eye.expand(C1.shape))
    Nt = solve_ge(eye + J2 @ C1, eye.expand(C1.shape))
    A2M = A2 @ M
    A = A2M @ A1
    b = (A2M @ (b1[..., None] + C1 @ eta2[..., None]))[..., 0] + b2
    C = A2M @ C1 @ _mT(A2) + C2
    NtJ2 = Nt @ J2
    eta = (_mT(A1) @ (Nt @ eta2[..., None] - NtJ2 @ b1[..., None]))[..., 0] + eta1
    J = _mT(A1) @ NtJ2 @ A1 + J1
    return (A, b, C, eta, J)


def lqr_cost_to_go(As, Bs, l_x, l_u, l_xx, lN_x, lN_xx, Rt_diag):
    """All cost-to-go quadratics (P_k, p_k), k = 0..H-1, in O(log H) depth.

    As [..., H-1, nx, nx], Bs [..., H-1, nx, nu] (expanded copies for LTI
    dynamics), stage gradients and Hessians l_x [..., H-1, nx],
    l_u [..., H-1, nu], l_xx [..., H-1, nx, nx], final lN_x [..., nx],
    lN_xx [..., nx, nx], control penalty diagonal Rt_diag [nu] (or
    [..., nu]); the batch axes `...` lead.

    Returns (Ps [..., H, nx, nx], ps [..., H, nx]), the unregularized
    sequential value recursion's quadratics.
    """
    dtype = l_x.dtype
    axis = l_x.dim() - 2
    Rinv = (1.0 / Rt_diag).to(dtype)                 # diagonal R
    B_Rinv = Bs * Rinv.unsqueeze(-2).unsqueeze(-2)
    C = B_Rinv @ _mT(Bs)
    b = -(B_Rinv @ l_u[..., None])[..., 0]
    eta = -l_x
    # the terminal element appended; A/b/C zero so that suffixes end there
    zm = torch.zeros_like(l_xx[..., :1, :, :])
    zv = torch.zeros_like(l_x[..., :1, :])
    A_e = torch.cat([As.expand_as(l_xx), zm], dim=axis)
    b_e = torch.cat([b, zv], dim=axis)
    C_e = torch.cat([C.expand_as(l_xx), zm], dim=axis)
    eta_e = torch.cat([eta, -lN_x[..., None, :]], dim=axis)
    J_e = torch.cat([l_xx, lN_xx[..., None, :, :]], dim=axis)
    # reverse=True folds in reversed index order (flip-scan-flip), so the
    # operands are swapped to keep combine_cvf's earlier-interval-first
    # convention
    _, _, _, etas, Js = associative_scan(
        lambda a, b: combine_cvf(b, a), (A_e, b_e, C_e, eta_e, J_e),
        reverse=True, axis=axis)
    return Js, -etas


def affine_suffix(Ms, vs):
    """Suffix compositions of affine maps d_k = M_k d_{k+1} + v_k.

    Ms [..., T, n, n], vs [..., T, n] (index k uses the map into step k;
    batch axes lead). Returns ds [..., T+1, n] with ds[T] = 0 and
    ds[k] = M_k ds[k+1] + v_k, by an associative scan over (M, v) pairs in
    O(log T) depth.
    """
    axis = vs.dim() - 2

    def comb(e2, e1):
        # e1 earlier: d_i = M1 d_j + v1 with d_j = M2 d_l + v2; operands
        # arrive later-first because reverse=True folds in reversed order
        M1, v1 = e1
        M2, v2 = e2
        return (M1 @ M2, (M1 @ v2[..., None])[..., 0] + v1)

    Ms_e = torch.cat([Ms, torch.zeros_like(Ms[..., :1, :, :])], dim=axis)
    vs_e = torch.cat([vs, torch.zeros_like(vs[..., :1, :])], dim=axis)
    _, ds = associative_scan(comb, (Ms_e, vs_e), reverse=True, axis=axis)
    return ds
