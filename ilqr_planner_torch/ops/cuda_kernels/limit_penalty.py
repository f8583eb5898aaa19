"""The fleet solver's joint-limit penalty over whole trajectories: CUDA
kernel, plain twins, wrapper.

No TPU kernel stands behind it: the JAX package writes the penalty in plain
jnp, which XLA fuses into one pass. Per element x of a trajectory
[H, n, B] and per limited subsystem (a row of `table` [nsub, 4, n]: smax,
smin, weight, penalty; the penalty repeated along n) the quadratic penalty
is active where the weight is not 0 and x lies over smax or under smin,
with weight Ld = penalty and gap ql = smax - x or smin - x there (0
elsewhere). Two forms:

- `limit_cost(X, Xd, alpha, table=)` -> [B]: the sum of Ld ql ql over
  steps, coordinates and subsystems, at X, or at X + alpha Xd (a trial of
  the fleet's affine line-search family, read from its base and direction
  without forming the trial trajectory);
- `limit_arrays(X, table=)` -> (lx, L2) [H, n, B]: lx = -sum Ld ql and
  L2 = sum Ld Ld, the backward sweep's streamed stage gradient and diagonal.

`limit_cost_reference` and `limit_arrays_reference` are the same math in
tensor ops, in the order the fleet solver ran it before the kernel. The
kernel (`csrc/limit_penalty.cu`) makes one streaming pass: a thread a few
neighbouring lanes, the rows walked in registers; its cost differs from the
twin's only in the order of a lane's sum, its arrays not at all. It is one
library for every width, type and batch, built at first use; the launch
geometry (`launch_geometry`) is chosen here from B, H, n and the type. The
wrapper runs the twins for CPU tensors and the kernel for CUDA tensors; it
never falls back from one to the other.
"""

import ctypes

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["limit_cost", "limit_arrays", "limit_cost_reference",
           "limit_arrays_reference", "build", "LAUNCHES", "launch_geometry"]

# Kernel launches so far, by form: one per CUDA call of `limit_cost` and of
# `limit_arrays`.
LAUNCHES = {"cost": 0, "arrays": 0}

# The launch constants of `csrc/limit_penalty.cu`: threads of an arrays
# block.
ARRAYS_THREADS = 128
# A cost block's rows of threads (each a share of the rows of the
# trajectory) double while the launch stays within one wave of the H100's
# 132 SMs (and a block within 1024 threads): small batches split the rows
# instead of walking them alone. A cost block is at least 128 threads.
COST_TARGET_THREADS = 132 * nvcc_build.THREADS_PER_SM
COST_MIN_THREADS = 128
# Rows (step, coordinate) an arrays block takes, at least.
ARRAYS_ROWS = 8
_GRID_Y_MAX = 65535

SOURCE = nvcc_build.CSRC / "limit_penalty.cu"


def _terms(X, row):
    """(Ld, ql) of the quadratic limit penalty over X [.., n, B] under one
    subsystem's row of the table."""
    smax, smin, weight, penalty = (v[:, None] for v in row)
    over = X > smax
    under = X < smin
    active = (weight != 0) & (over | under)
    zero = torch.zeros_like(X)
    Ld = torch.where(active, penalty, zero)
    ql = torch.where(over, smax - X, torch.where(under, smin - X, zero))
    return Ld, torch.where(active, ql, zero)


def limit_cost_reference(X, Xd=None, alpha=0.0, *, table):
    """Total limit-penalty cost [B] of the trajectory X [H, n, B], or of
    X + alpha Xd where Xd is given; table [nsub, 4, n]."""
    if Xd is not None:
        X = X + alpha * Xd
    cost = torch.zeros_like(X[0, 0])
    for row in table:
        Ld, ql = _terms(X, row)
        cost = cost + (Ld * ql * ql).sum((0, 1))
    return cost


def limit_arrays_reference(X, *, table):
    """Limit gradient and diagonal Hessian over X [H, n, B]: (lx, L2), with
    lx = -Lq the negated gradient; table [nsub, 4, n]."""
    Lq = torch.zeros_like(X)
    L2 = torch.zeros_like(X)
    for row in table:
        Ld, ql = _terms(X, row)
        Lq = Lq + Ld * ql
        L2 = L2 + Ld * Ld
    return -Lq, L2


def _vec(B, dtype, *arrays):
    """Lanes a thread: one 16-byte load a row where B and every array's
    address and step stride allow it, else 1."""
    v = 16 // (torch.finfo(dtype).bits // 8)
    ok = B % v == 0 and all(a.data_ptr() % 16 == 0 and a.stride(0) % v == 0
                            for a in arrays)
    return v if ok else 1


def launch_geometry(form, B, dtype, H, n, vec=None):
    """The launch of `form` ('cost' or 'arrays') at batch B over [H, n, B]
    -> dict(vec (lanes a thread), blocks, grid, block (threads along the
    lanes, along the rows), threads (a block), lanes_per_block,
    rows_per_block, smem_bytes (a block), lanes_per_sm (by
    shared memory and threads, `nvcc_build.resident_blocks`)). vec: lanes a
    thread, 16 bytes' worth where B allows it when None. Needs no card."""
    itemsize = torch.finfo(dtype).bits // 8
    if vec is None:
        vec = 16 // itemsize if B % (16 // itemsize) == 0 else 1
    nv = -(-B // vec)
    rows = H * n
    if form == "cost":
        ty = 1
        while (2 * ty <= 32 and 2 * ty <= rows
               and nv * 2 * ty <= COST_TARGET_THREADS):
            ty *= 2
        block = (max(32, COST_MIN_THREADS // ty), ty)
        grid = (-(-nv // block[0]), 1)
        smem = block[0] * ty * vec * itemsize
        rows_per_block = rows
    elif form == "arrays":
        block = (ARRAYS_THREADS, 1)
        rows_per_block = max(ARRAYS_ROWS, -(-rows // _GRID_Y_MAX))
        grid = (-(-nv // ARRAYS_THREADS), -(-rows // rows_per_block))
        smem = 0
    else:
        raise ValueError(f"form must be 'cost' or 'arrays', got {form!r}")
    threads, lanes = block[0] * block[1], block[0] * vec
    return {"vec": vec, "blocks": grid[0] * grid[1], "grid": grid,
            "block": block, "threads": threads, "lanes_per_block": lanes,
            "rows_per_block": rows_per_block, "smem_bytes": smem,
            "lanes_per_sm": lanes * nvcc_build.resident_blocks(threads, smem)}


def _entries():
    entries = {}
    for tag, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        entries[f"limit_penalty_cost_{tag}"] = (
            [ctypes.c_void_p, ctypes.c_void_p, real, ctypes.c_longlong,
             ctypes.c_void_p] + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_void_p])
        entries[f"limit_penalty_arrays_{tag}"] = (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    return entries


def build():
    """Compile `csrc/limit_penalty.cu` for sm_90a (once per source content)
    -> (path of the shared library, ptxas report)."""
    return nvcc_build.build(SOURCE)


def _check(X, Xd, table):
    """Raise on anything the kernel does not take. Needs no card."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"limit_penalty kernel takes float32/float64, got "
                        f"{X.dtype}")
    if X.dim() != 3:
        raise ValueError(f"limit_penalty kernel takes X [H, n, B], got shape "
                         f"{tuple(X.shape)}")
    H, n, B = X.shape
    if X.stride(2) != 1 or X.stride(1) != B:
        raise ValueError(f"limit_penalty kernel: X needs its [n, B] rows "
                         f"contiguous, got strides {X.stride()}")
    named = {"table": (table, (table.shape[0], 4, n))}
    if Xd is not None:
        named["Xd"] = (Xd, (H, n, B))
    for name, (a, shape) in named.items():
        if a.device != X.device:
            raise ValueError(f"limit_penalty kernel: {name} must be on "
                             f"{X.device}, got {a.device}")
        if a.dtype != X.dtype:
            raise TypeError(f"limit_penalty kernel: {name} is {a.dtype}, X is "
                            f"{X.dtype}")
        if tuple(a.shape) != shape or a.shape[0] < 1:
            raise ValueError(f"limit_penalty kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
    if not table.is_contiguous():
        raise ValueError("limit_penalty kernel: table is not contiguous")
    if Xd is not None and Xd.stride() != X.stride():
        raise ValueError(f"limit_penalty kernel: Xd has strides {Xd.stride()}, "
                         f"X {X.stride()}")


def _lib():
    return nvcc_build.load(SOURCE, _entries())


def limit_cost(X, Xd=None, alpha=0.0, *, table):
    """Total limit-penalty cost [B] of X [H, n, B], or of X + alpha Xd;
    arguments as `limit_cost_reference`. CPU tensors run the twin; CUDA
    tensors launch the kernel on the current stream (rows [n, B]
    contiguous, any step stride, Xd strided as X)."""
    if X.device.type == "cpu":
        return limit_cost_reference(X, Xd, alpha, table=table)
    _check(X, Xd, table)
    H, n, B = X.shape
    cost = X.new_empty((B,))
    if B == 0:
        return cost
    arrays = (X,) if Xd is None else (X, Xd)
    g = launch_geometry("cost", B, X.dtype, H, n, _vec(B, X.dtype, *arrays))
    tag = "f32" if X.dtype == torch.float32 else "f64"
    fn = getattr(_lib(), f"limit_penalty_cost_{tag}")
    dev = X.device
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), None if Xd is None else Xd.data_ptr(),
                 float(alpha), X.stride(0), table.data_ptr(), table.shape[0],
                 H, n, B, g["vec"], *g["block"], cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"limit_penalty cost kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["cost"] += 1
    return cost


def limit_arrays(X, *, table):
    """(lx, L2) [H, n, B] of X [H, n, B]; arguments as
    `limit_arrays_reference`. CPU tensors run the twin; CUDA tensors launch
    the kernel on the current stream (rows [n, B] contiguous, any step
    stride; the outputs contiguous)."""
    if X.device.type == "cpu":
        return limit_arrays_reference(X, table=table)
    _check(X, None, table)
    H, n, B = X.shape
    lx = X.new_empty((H, n, B))
    L2 = X.new_empty((H, n, B))
    if B == 0:
        return lx, L2
    g = launch_geometry("arrays", B, X.dtype, H, n, _vec(B, X.dtype, X))
    tag = "f32" if X.dtype == torch.float32 else "f64"
    fn = getattr(_lib(), f"limit_penalty_arrays_{tag}")
    dev = X.device
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), X.stride(0), table.data_ptr(), table.shape[0],
                 H, n, B, g["vec"], g["rows_per_block"], lx.data_ptr(),
                 L2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"limit_penalty arrays kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["arrays"] += 1
    return lx, L2
