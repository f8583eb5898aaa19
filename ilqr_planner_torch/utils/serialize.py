"""CSV record-and-replay serialization.

The port's copy of the JAX package's `utils/serialize.py`, the equivalent
of the reference's EigenSerialize (utils.cpp:21-61, utils.h:21-49): save
and load lists of vectors (e.g. a solved control sequence) as plain CSV so
that trajectories can be replayed on a robot-side consumer. The files are
the JAX package's, byte for byte; the savers take tensors on any device.
"""

import numpy as np
import torch

__all__ = ["save_csv", "load_csv", "save_matrix_list", "load_matrix_list"]


def _array(x) -> np.ndarray:
    """A tensor (any device), an array, or a list of either -> float64
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(float)
    if isinstance(x, (list, tuple)):
        return np.asarray([_array(v) for v in x], dtype=float)
    return np.asarray(x, dtype=float)


def save_csv(rows, filename: str) -> bool:
    """Save a 2-D array (or list of 1-D vectors) as CSV, one vector per line."""
    arr = _array(rows)
    if arr.ndim == 1:
        arr = arr[:, None]
    np.savetxt(filename, arr, delimiter=",", fmt="%.18g")
    return True


def load_csv(filename: str) -> np.ndarray:
    """Load a CSV saved by save_csv; returns (n_rows, n_cols) float64."""
    return np.atleast_2d(np.loadtxt(filename, delimiter=","))


_MATRIX_SEP = "=================================== "


def save_matrix_list(mats, filename: str) -> bool:
    """Save a list of matrices, '=' separator between blocks: the format of
    EigenSerialize::save(vector<MatrixXd>) (utils.cpp:33-44)."""
    with open(filename, "w") as f:
        for m in mats:
            for row in np.atleast_2d(_array(m)):
                f.write(",".join(f"{v:.18g}" for v in row) + "\n")
            f.write(_MATRIX_SEP + "\n")
    return True


def load_matrix_list(filename: str):
    """Load a file written by save_matrix_list."""
    mats, rows = [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("="):
                if rows:
                    mats.append(np.array(rows))
                rows = []
            else:
                rows.append([float(v) for v in line.split(",")])
    if rows:
        mats.append(np.array(rows))
    return mats
