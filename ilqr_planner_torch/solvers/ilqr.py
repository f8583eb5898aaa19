"""Result type of the recursive iLQR solvers.

PyTorch counterpart of `ILQRResult` in the JAX package's `solvers/ilqr.py`.
The single-problem solver itself is ROADMAP slice 2: the fleet path does not
need it.
"""

import dataclasses
from typing import Optional

import torch

__all__ = ["ILQRResult"]


@dataclasses.dataclass
class ILQRResult:
    """X [.., H, nx], fX [.., H, nt], U [.., H-1, nu], Ks [.., H-1, nu, nx],
    ds [.., H-1, nu] (scaled by the accepted alpha), final cost, iterations
    used and the last alpha; a fleet solve adds a leading scenario axis."""

    X: torch.Tensor
    fX: torch.Tensor
    U: torch.Tensor
    Ks: torch.Tensor
    ds: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor
    alpha: torch.Tensor
    progress: Optional[dict] = None
