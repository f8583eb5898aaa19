"""Whole-trajectory closed-loop trial rollout of the time-optimal
first-order kind: CUDA kernel, plain twin, wrapper.

PyTorch counterpart of the JAX package's
`ops/pallas_kernels/rollout_time1.py` (the Pallas TPU kernel
`rollout_time1_pallas` / `rollout_from_steps`). One launch runs all H-1
steps of
    du = K (x - xo) + alpha d,   u = uo + du,
    q' = q + s^2 u_q,            t' = t + s^2        (s = u[m-1])
n threads a scenario lane (a warp a row of the gains), the state in
registers, the inputs of the next steps in flight through a ring in shared
memory, and writes x', u and ||du||^2 per step (`launch_geometry` gives the
blocks, threads and shared memory of a launch). The caller assembles the
trial's cost from the returned trajectory. `rollout_time1_reference` is
the same per-step math over [n, B] tensors with a Python loop over steps.

The kernel reads the gains, the feed-forward terms and the reference
trajectory where they lie: the JAX package's packing of them into one
array per backward pass (`build_steps`, made for the TPU's DMA) is not
carried over. The wrapper runs the twin for CPU tensors and the kernel for
CUDA tensors (any n = m = dof + 1 from 2 up to `MAX_N`, each width its own
library, built at first use); it never falls back from one to the other,
and a width the source cannot take raises before any build.
"""

import ctypes

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["rollout_time1", "rollout_time1_reference", "build", "LAUNCHES",
           "MAX_N", "launch_geometry", "kernel_geometry"]

# Kernel launches so far: one per CUDA call of `rollout_time1`.
LAUNCHES = 0
# The largest state width n = m (the chain's DoF plus the time state) the
# source takes, by type: the largest whose block fits one H100 SM (n threads
# a lane, the ring's shared memory) and whose every width up to it builds
# without a register spill (`python3 tools/width_scan.py`, on the card).
MAX_N = {torch.float32: 15, torch.float64: 10}

# The launch constants of `csrc/rollout_time1.cu`: lanes a block, step tiles
# in the shared-memory ring (a lane runs n threads, one a row of the gains).
LANES_PER_BLOCK = 32
RING_STAGES = 6

SOURCE = nvcc_build.CSRC / "rollout_time1.cu"


def launch_geometry(B, dtype, n):
    """The kernel's launch at width n and batch B
    (`nvcc_build.launch_geometry`: blocks, threads, shared memory a block,
    lanes an SM). Needs no card."""
    # a step's tile (gains, d, xo, uo) in each ring stage; u, du of two steps
    values = RING_STAGES * (n * n + 3 * n) + 4 * n
    return nvcc_build.launch_geometry(B, LANES_PER_BLOCK, n, values,
                                      torch.finfo(dtype).bits // 8)


def rollout_time1_reference(alpha, Ks, ds, Xref, Uref, x0):
    """Closed-loop trial rollout -> (X [H, n, B], U [H-1, m, B],
    du2 [H-1, B]), du2_k = ||du_k||^2.

    Ks [H-1, m, n, B], ds/Uref [H-1, m, B], Xref [H, n, B] (rows 0..H-2
    read), x0 [n, B], alpha a float; n = m = dof + 1.
    """
    Hm1, m, n, B = Ks.shape
    dof = m - 1
    X = x0.new_empty((Hm1 + 1, n, B))
    U = x0.new_empty((Hm1, m, B))
    du2 = x0.new_empty((Hm1, B))
    X[0] = x = x0
    for k in range(Hm1):
        du = (Ks[k] * (x - Xref[k])[None]).sum(1) + alpha * ds[k]
        u = Uref[k] + du
        dtk = u[m - 1] * u[m - 1]
        x = torch.cat([x[:dof] + dtk * u[:dof], (x[n - 1] + dtk)[None]])
        X[k + 1], U[k], du2[k] = x, u, (du * du).sum(0)
    return X, U, du2


def _defines(n):
    return (f"ROLLOUT_N={n}",)


def _entries(n):
    entries = {f"rollout_time1_n{n}_{tag}": [ctypes.c_void_p] * 5 + [alpha_type]
               + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
               for tag, alpha_type in (("f32", ctypes.c_float),
                                       ("f64", ctypes.c_double))}
    entries["rollout_time1_geometry"] = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    return entries


def build(n, defines=()):
    """Compile `csrc/rollout_time1.cu` at width n for sm_90a (once per
    source content, width and design `defines`) -> (path of the shared
    library, ptxas report)."""
    return nvcc_build.build(SOURCE, _defines(n) + tuple(defines))


def kernel_geometry(B, dtype, n):
    """What the built kernel of width n itself launches at batch B, asked
    of the library on the card (`nvcc_build.kernel_geometry`);
    `launch_geometry` must agree on blocks, threads and shared memory."""
    fn = nvcc_build.load(SOURCE, _entries(n), _defines(n)).rollout_time1_geometry
    return nvcc_build.kernel_geometry(fn, n, torch.finfo(dtype).bits // 8, B)


def _check(Ks, ds, Xref, Uref, x0):
    """Raise on anything the kernel does not take. Needs no card."""
    Hm1, m, n, B = Ks.shape
    if Ks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rollout_time1 kernel takes float32/float64, got "
                        f"{Ks.dtype}")
    if n != m or not 2 <= n <= MAX_N[Ks.dtype]:
        raise ValueError(f"rollout_time1 kernel takes n = m from 2 to "
                         f"{MAX_N[Ks.dtype]} in {Ks.dtype} (a chain of up to "
                         f"{MAX_N[Ks.dtype] - 1} joints and the time state); "
                         f"got n={n}, m={m} (ROADMAP Queue 3 F3)")
    shapes = {"Ks": (Ks, (Hm1, m, n, B)), "ds": (ds, (Hm1, m, B)),
              "Xref": (Xref, (Hm1 + 1, n, B)), "Uref": (Uref, (Hm1, m, B)),
              "x0": (x0, (n, B))}
    for name, (a, shape) in shapes.items():
        if a.device.type != "cuda" or a.device != Ks.device:
            raise ValueError(f"rollout_time1 kernel: {name} must be a CUDA "
                             f"tensor on {Ks.device}, got {a.device}")
        if a.dtype != Ks.dtype:
            raise TypeError(f"rollout_time1 kernel: {name} is {a.dtype}, Ks is "
                            f"{Ks.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"rollout_time1 kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"rollout_time1 kernel: {name} is not contiguous")


def rollout_time1(alpha, Ks, ds, Xref, Uref, x0):
    """Closed-loop trial rollout -> (X [H, n, B], U [H-1, m, B],
    du2 [H-1, B]); arguments as `rollout_time1_reference`. CPU tensors run
    the twin; CUDA tensors launch the kernel on the current stream
    (n = m up to `MAX_N`, float32 or float64). A horizon H < 2 raises."""
    global LAUNCHES
    if Ks.dim() != 4 or Ks.shape[0] < 1:
        raise ValueError(f"rollout_time1 needs gains Ks [H-1, m, n, B] with a "
                         f"horizon H >= 2; got Ks of shape {tuple(Ks.shape)}")
    devices = {a.device for a in (Ks, ds, Xref, Uref, x0)}
    if len(devices) != 1:
        raise ValueError(f"rollout_time1: the arrays lie on more than one "
                         f"device: {sorted(map(str, devices))}")
    if Ks.device.type == "cpu":
        return rollout_time1_reference(alpha, Ks, ds, Xref, Uref, x0)
    _check(Ks, ds, Xref, Uref, x0)
    Hm1, m, n, B = Ks.shape
    X = Ks.new_empty((Hm1 + 1, n, B))
    U = Ks.new_empty((Hm1, m, B))
    du2 = Ks.new_empty((Hm1, B))
    if B == 0:
        return X, U, du2
    tag = "f32" if Ks.dtype == torch.float32 else "f64"
    fn = getattr(nvcc_build.load(SOURCE, _entries(n), _defines(n)),
                 f"rollout_time1_n{n}_{tag}")
    dev = Ks.device
    with torch.cuda.device(dev):
        err = fn(Ks.data_ptr(), ds.data_ptr(), Xref.data_ptr(), Uref.data_ptr(),
                 x0.data_ptr(), float(alpha), X.data_ptr(), U.data_ptr(),
                 du2.data_ptr(), Hm1, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rollout_time1 kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return X, U, du2
