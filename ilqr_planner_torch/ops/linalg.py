"""Small-matrix linear algebra in plain tensor ops.

PyTorch counterpart of `solve_spd` in the JAX package's `ops/linalg.py`. The
solver sweeps solve tiny (<= 16 dim) SPD-plus-ridge systems every time step;
Gauss-Jordan without pivoting on the augmented system, in the JAX package's
elimination order, keeps every row index static and the results comparable
term by term. The pivoted `solve_ge` / `inv_ge` come with the slice that
needs them (ROADMAP Queue 1 item 10).
"""

import torch

__all__ = ["solve_spd"]


def solve_spd(A, B):
    """A^{-1} B for (near-)symmetric-positive-definite A [..., n, n], no
    pivoting. B is [..., n, m], or (with one axis fewer than A) a vector
    [..., n]; batch axes broadcast.
    """
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    M = torch.cat([A.expand(*batch, n, n), B.expand(*batch, n, B.shape[-1])],
                  dim=-1)                                  # [..., n, n+m]
    for i in range(n):
        piv_row = M[..., i, :] / M[..., i, i:i + 1]
        factors = M[..., :, i].clone()
        factors[..., i] = 0.0
        M = M - factors[..., None] * piv_row[..., None, :]
        M[..., i, :] = piv_row
    X = M[..., :, n:]
    return X[..., 0] if vec else X
