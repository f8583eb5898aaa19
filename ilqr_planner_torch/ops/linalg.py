"""Small-matrix linear algebra in plain tensor ops.

PyTorch counterpart of the JAX package's `ops/linalg.py`: Gauss-Jordan
elimination on the augmented system [A | B], in the JAX package's order of
operations, so that results compare term by term.

  * `solve_spd` / `inv_spd`: no pivoting, every row index static, for the
    SPD-plus-ridge systems the solver sweeps solve every time step;
  * `solve_ge` / `inv_ge`: partial pivoting, each batch element choosing
    its own pivot rows (the parallel-prefix combination of `ops/pscan.py`
    solves (I + C J), which is not symmetric).
"""

import torch

__all__ = ["solve_ge", "inv_ge", "solve_spd", "inv_spd"]


def _augmented(A, B):
    """([..., n, n+m] = [A | B] over the broadcast batch, vec): B may be a
    vector [..., n] (one axis fewer than A)."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    M = torch.cat([A.expand(*batch, n, n), B.expand(*batch, n, B.shape[-1])],
                  dim=-1)
    return M, vec


def solve_ge(A, B):
    """A^{-1} B by Gauss-Jordan with partial pivoting: A [..., n, n],
    B [..., n, m] or a vector [..., n]; batch axes broadcast.

    At column i each batch element takes the first row p >= i of largest
    |M[p, i]| (`torch.argmax` returns the first maximal index, as
    `jnp.argmax` does), swaps rows i and p by a gather and a scatter over
    the batch, normalizes row i and eliminates column i from every other
    row.
    """
    M, vec = _augmented(A, B)
    n, w = A.shape[-1], M.shape[-1]
    rows = torch.arange(n, device=M.device)
    neg_inf = torch.tensor(float("-inf"), dtype=M.dtype, device=M.device)
    for i in range(n):
        col = torch.where(rows < i, neg_inf, M[..., :, i].abs())
        p = torch.argmax(col, dim=-1)                        # [...]
        idx = p[..., None, None].expand(*p.shape, 1, w)
        row_i = M[..., i:i + 1, :].clone()
        row_p = M.gather(-2, idx)
        M[..., i:i + 1, :] = row_p
        M.scatter_(-2, idx, row_i)
        piv_row = M[..., i, :] / M[..., i, i:i + 1]
        M[..., i, :] = piv_row
        factors = torch.where(rows == i, 0.0, M[..., :, i])
        M = M - factors[..., None] * piv_row[..., None, :]
    X = M[..., :, n:]
    return X[..., 0] if vec else X


def inv_ge(A):
    """Matrix inverse via solve_ge against the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return solve_ge(A, eye.expand(A.shape))


def solve_spd(A, B):
    """A^{-1} B for (near-)symmetric-positive-definite A [..., n, n], no
    pivoting. B is [..., n, m], or (with one axis fewer than A) a vector
    [..., n]; batch axes broadcast.
    """
    M, vec = _augmented(A, B)
    n = A.shape[-1]
    for i in range(n):
        piv_row = M[..., i, :] / M[..., i, i:i + 1]
        factors = M[..., :, i].clone()
        factors[..., i] = 0.0
        M = M - factors[..., None] * piv_row[..., None, :]
        M[..., i, :] = piv_row
    X = M[..., :, n:]
    return X[..., 0] if vec else X


def inv_spd(A):
    """Inverse of (near-)SPD A via solve_spd against the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return solve_spd(A, eye.expand(A.shape))
