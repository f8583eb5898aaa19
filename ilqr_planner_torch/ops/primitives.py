"""Control-primitive basis builders (Psi matrices).

The port's own copy of the JAX package's `ops/primitives.py` (numpy only;
the port imports nothing of that package). Host-side (NumPy, float64)
equivalents of the reference basis constructors (reference:
ilqr_planner/src/utils/primitives.cpp:13-97). All builders map
`(dim, K) -> (dim, K)` (linear: `(dim, 2K)`); the result is typically expanded
to the control space via `np.kron(psi, np.eye(nb_ctrl))` exactly as in the
tutorials (POS_ORN_SYS.ipynb cell 9) and consumed by the control-primitive
batch solver. These run once at problem-build time, so NumPy is the right
tool; a solve moves the result to its device.
"""

import math

import numpy as np

__all__ = [
    "build_psi_rbf",
    "build_psi_bernstein",
    "build_psi_unitstep",
    "build_psi_sawtooth",
    "build_psi_linear",
]


def build_psi_rbf(dim: int, K: int) -> np.ndarray:
    """Gaussian radial-basis bumps (primitives.cpp:19-33)."""
    Ts = np.linspace(0.0, dim - 1, dim)
    bw = float(dim) / K
    sig = bw
    psi = np.zeros((dim, K))
    avg = bw / 2
    for i in range(K):
        psi[:, i] = 1.0 / (2 * np.pi * sig) * np.exp(-((Ts - avg) ** 2) / (2 * sig * sig))
        avg += bw
    return psi


def build_psi_bernstein(dim: int, K: int) -> np.ndarray:
    """Bernstein/Bezier polynomial basis of order K-1 (primitives.cpp:35-50)."""
    Ts = np.linspace(0.0, dim - 1, dim)
    order = K - 1
    Ts = Ts / Ts.max()
    psi = np.zeros((dim, K))
    for i in range(K):
        binom = math.comb(order, i)
        psi[:, i] = binom * (Ts**i) * ((1.0 - Ts) ** (order - i))
    return psi


def build_psi_unitstep(dim: int, K: int) -> np.ndarray:
    """Piecewise-constant steps with height 1/bw (primitives.cpp:52-69).

    Bandwidth uses round(dim/K) like the reference, so the last basis column
    can under- or over-cover when K does not divide dim.
    """
    bw = int(round(float(dim) / K))
    psi = np.zeros((dim, K))
    low = 0
    for i in range(K):
        j = np.arange(dim)
        psi[:, i] = np.where((j >= low) & (j < low + bw), 1.0 / bw, 0.0)
        low += bw
    return psi


def build_psi_sawtooth(dim: int, K: int) -> np.ndarray:
    """Centered ramps over ceil(dim/K)-wide windows (primitives.cpp:71-88)."""
    bw = int(math.ceil(float(dim) / K))
    psi = np.zeros((dim, K))
    low = 0.0
    for i in range(K):
        j = np.arange(dim)
        psi[:, i] = np.where((j >= low) & (j < low + bw), (j - low) / (bw - 1) - 0.5, 0.0)
        low += bw
    return psi


def build_psi_linear(dim: int, K: int) -> np.ndarray:
    """[unitstep, sawtooth] horizontally stacked, dim x 2K (primitives.cpp:90-96)."""
    return np.hstack([build_psi_unitstep(dim, K), build_psi_sawtooth(dim, K)])
