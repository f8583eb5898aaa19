"""The fleet solver's keypoint cost of a trajectory or of a line-search
trial in one CUDA launch: table, wrapper.

No TPU kernel stands behind it: the JAX package writes the keypoint terms
in plain jnp (`_kp_terms_at`), which XLA fuses. `kp_cost(X, U, cost, Xd,
Ud, alpha, table=)` -> [B] adds to `cost` what the fleet's tensor path
(`solvers/fleet.py::_kp_cost_ops`, its plain twin) adds: at each keypoint
step k, the control penalty sum_j Rt_j u_j^2 of each system with a
keypoint there (k < H-1), then the sum of their residuals' e^T P e, of X
and U or of the affine trial X + alpha Xd, U + alpha Ud (read from its base
and direction without forming it). The kernel (`csrc/kp_cost.cu`) runs one
thread a lane, the chain walk, the residual and the sum in registers; it
covers the first-order posorn, posorn_time and point systems on one serial
chain, with or without object frames, whose keypoint constants are not
bound to lanes: the fleet packs the table of such a spec
(`solvers/fleet.py::_kp_table`) and chooses between the kernel and its
tensor path (`_kp_cost`). This module keeps what the CUDA source defines:
the table's layout and flags, the block and the launch. The wrapper takes
CUDA tensors only, and raises on anything else it cannot take.
"""

import ctypes
from typing import NamedTuple

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["kp_cost", "KpTable", "build", "smem_bytes", "LAUNCHES", "THREADS",
           "KINDS"]

# Kernel launches so far: one per call of `kp_cost`.
LAUNCHES = 0

# Threads of a block, one lane each (KP_THREADS in the source).
THREADS = 128
# The system kinds the kernel takes (meta code 0: posorn, 1: point).
KINDS = {"posorn": 0, "posorn_time": 0, "point": 1}
# Residual rows at most (kMaxRows in the source).
MAX_ROWS = 7
# The table's layout (the source's kHeader, kJoint, kSys, kStep, kKp) and
# the keypoint flags.
HEADER, JOINT, SYS, STEP, KP = 4, 33, 4, 3, 8
TARGET_ZERO, RADIUS, THRESH = 1, 2, 4
SMEM_MAX = 48 * 1024

SOURCE = nvcc_build.CSRC / "kp_cost.cu"


class KpTable(NamedTuple):
    """The kernel's constants: `vals` [nvals] in the spec's dtype, `meta`
    [nmeta] int32, on the spec's device; the trajectory's H, n, m.

    vals: per joint origin_pos, origin_rot, axis, K, K^2 (JOINT values),
    the tip's pos and rot; per system its frame (R_f^T, p_f) if any and its
    Rt; per keypoint mu, P and, for the posorn kinds, E [3, 4] then the unit
    target quaternion, then the dead zones' radius and thresholds. meta
    (offsets into vals): nj, nsys, nsteps, nkp (HEADER); prismatic [nj]; per
    system (kind, time, frame offset or -1, Rt offset) (SYS); per keypoint
    step in order (k, first keypoint, keypoints) (STEP); per keypoint in the
    step's order (system, nq, mu offset, nt, P offset, quaternion offset or
    -1, dead-zone offset, flags) (KP)."""
    vals: torch.Tensor
    meta: torch.Tensor
    H: int
    n: int
    m: int


def _entries():
    entries = {}
    for tag, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        entries[f"kp_cost_{tag}"] = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, real, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 3)
    return entries


def build():
    """Compile `csrc/kp_cost.cu` for sm_90a (once per source content) ->
    (path of the shared library, ptxas report)."""
    return nvcc_build.build(SOURCE)


def smem_bytes(table: KpTable) -> int:
    """Dynamic shared memory of a block: the staged table."""
    return (table.vals.numel() * table.vals.element_size()
            + table.meta.numel() * 4)


def _check(X, U, cost, Xd, Ud, table):
    """Raise on anything the kernel does not take. Needs no card."""
    if X.device.type != "cuda":
        raise ValueError(f"kp_cost kernel takes CUDA tensors, got {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kp_cost kernel takes float32/float64, got {X.dtype}")
    H, n, m = table.H, table.n, table.m
    if X.dim() != 3 or tuple(X.shape[:2]) != (H, n):
        raise ValueError(f"kp_cost kernel takes X [{H}, {n}, B], got shape "
                         f"{tuple(X.shape)}")
    B = X.shape[2]
    if (Xd is None) != (Ud is None):
        raise ValueError("kp_cost kernel: Xd and Ud are given together")
    named = {"X": (X, (H, n, B)), "U": (U, (H - 1, m, B)), "cost": (cost, (B,)),
             "table.vals": (table.vals, tuple(table.vals.shape))}
    if Xd is not None:
        named.update(Xd=(Xd, (H, n, B)), Ud=(Ud, (H - 1, m, B)))
    for name, (a, shape) in named.items():
        if a.device != X.device:
            raise ValueError(f"kp_cost kernel: {name} must be on {X.device}, "
                             f"got {a.device}")
        if a.dtype != X.dtype:
            raise TypeError(f"kp_cost kernel: {name} is {a.dtype}, X is "
                            f"{X.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"kp_cost kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if a.dim() == 3 and (a.stride(2) != 1 or a.stride(1) != B):
            raise ValueError(f"kp_cost kernel: {name} needs its rows [., B] "
                             f"contiguous, got strides {a.stride()}")
    if not (cost.is_contiguous() and table.vals.is_contiguous()):
        raise ValueError("kp_cost kernel: cost and table.vals are contiguous")
    if table.meta.device != X.device or table.meta.dtype != torch.int32:
        raise ValueError("kp_cost kernel: table.meta is int32 on X's device")
    if smem_bytes(table) > SMEM_MAX:
        raise ValueError(f"kp_cost kernel: the table takes {smem_bytes(table)} "
                         f"bytes, a block stages at most {SMEM_MAX}")


def _lib():
    return nvcc_build.load(SOURCE, _entries())


def kp_cost(X, U, cost, Xd=None, Ud=None, alpha=0.0, *, table: KpTable):
    """cost [B] plus the keypoint and control costs of X [H, n, B] and
    U [H-1, m, B], or of the affine trial X + alpha Xd, U + alpha Ud (Xd, Ud
    shaped as X, U), CUDA tensors: one launch on the current stream (every
    array with its [., B] rows contiguous, any step stride; cost
    contiguous). Returns a new tensor."""
    _check(X, U, cost, Xd, Ud, table)
    B = X.shape[2]
    out = torch.empty_like(cost)
    if B == 0:
        return out
    tag = "f32" if X.dtype == torch.float32 else "f64"
    fn = getattr(_lib(), f"kp_cost_{tag}")
    dev = X.device
    affine = Xd is not None
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), Xd.data_ptr() if affine else None, X.stride(0),
                 Xd.stride(0) if affine else 0, U.data_ptr(),
                 Ud.data_ptr() if affine else None, U.stride(0),
                 Ud.stride(0) if affine else 0, float(alpha),
                 table.meta.data_ptr(), table.meta.numel(),
                 table.vals.data_ptr(), table.vals.numel(), table.n, table.m,
                 table.H, B, cost.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kp_cost kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
