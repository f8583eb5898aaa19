"""Whole-sweep first-order backward pass: CUDA kernel, plain twin, wrapper.

PyTorch counterpart of the JAX package's
`ops/pallas_kernels/segment_backward.py` (the Pallas TPU kernel).
The kernel (`csrc/segment_backward.cu`) runs all H-1 steps of the collapsed
first-order LTI recursion in one launch, one thread a lane; its launch is
in `launch_geometry`.
`segment_backward_reference` is the same per-step math over [n, n, B]
tensors with a Python loop over steps.

The kernel is built with nvcc at first use, one library a chain width n,
from the source in this package, into `ilqr_planner_torch/build/`, and
loaded with ctypes (`nvcc_build`). `segment_backward` runs the twin for CPU
tensors and the kernel for CUDA tensors; it never falls back from one to the
other, and a width the source cannot take (above `MAX_N`) raises before any
build.
"""

import ctypes
import functools

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["segment_backward", "segment_backward_reference", "build",
           "LAUNCHES", "MAX_N", "launch_geometry", "kernel_geometry"]

# Kernel launches so far: one per CUDA call of `segment_backward`.
LAUNCHES = 0
# The largest chain n the source takes, by type: the largest whose block
# fits one H100 SM and whose every width up to it builds without a register
# spill (`python3 tools/width_scan.py`, on the card).
MAX_N = {torch.float32: 10, torch.float64: 7}

# The launch constants of `csrc/segment_backward.cu`: lanes (threads) a
# block, the steps whose rows are in flight.
LANES_PER_BLOCK = 32
STEPS_AHEAD = 1

SOURCE = nvcc_build.CSRC / "segment_backward.cu"


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def segment_backward_reference(P0, p0, L2, lx, U, gxx, kp_steps, dt, Rt,
                               reg=1e-6):
    """Full backward sweep -> (Ks [H-1, n, n, B], ds [H-1, n, B]).

    P0 [n, n, B], p0 [n, B]: terminal cost-to-go. L2/lx/U [H-1, n, B]: the
    limit diagonal, the stage gradient (keypoint -J^T P e folded in) and the
    controls. gxx [n_kp, n, n, B]: dense keypoint Hessians at the steps
    `kp_steps`, upper triangle read. dt, reg and Rt enter in the working
    dtype, as the kernel receives them.
    """
    n, _, B = P0.shape
    dtype, dev = P0.dtype, P0.device
    params = torch.tensor([dt, reg, *[float(v) for v in Rt]], dtype=dtype,
                          device=dev)
    dt, reg, r = params[0], params[1], params[2:, None]    # r [n, 1]
    rr = r + reg
    dt2 = dt * dt
    inv_dt = 1.0 / dt
    inv_dt2 = inv_dt * inv_dt
    eye = torch.eye(n, dtype=dtype, device=dev)[:, :, None]
    lower = eye.new_ones(n, n).tril().bool()[:, :, None]
    slot = {int(k): i for i, k in enumerate(kp_steps)}

    P, p = P0, p0
    Hm1 = U.shape[0]
    Ks = torch.empty((Hm1, n, n, B), dtype=dtype, device=dev)
    ds = torch.empty((Hm1, n, B), dtype=dtype, device=dev)
    for t in range(Hm1 - 1, -1, -1):
        M = dt2 * P + eye * rr[:, :, None]
        # Cholesky M = L L^T, Li = 1 / diag(L)
        L = torch.zeros_like(M)
        Li = torch.empty_like(p)
        for j in range(n):
            Ljj = torch.sqrt(M[j, j] - (L[j, :j] * L[j, :j]).sum(0))
            Li[j] = 1.0 / Ljj
            L[j + 1:, j] = (M[j + 1:, j]
                            - (L[j + 1:, :j] * L[j, :j][None]).sum(1)) * Li[j]
        # M^-1: W = L^-1 by rows, then L^T X = W from the bottom row up;
        # the lower triangle is kept and mirrored
        W = torch.zeros_like(M)
        for i in range(n):
            W[i] = (eye[i] - (L[i, :i, None] * W[:i]).sum(0)) * Li[i]
        Minv = torch.zeros_like(M)
        for i in range(n - 1, -1, -1):
            Minv[i] = (W[i] - (L[i + 1:, i, None] * Minv[i + 1:]).sum(0)) * Li[i]
        Minv = torch.where(lower, Minv, Minv.transpose(0, 1))

        u = U[t]
        K = (Minv * rr[None] - eye) * inv_dt                  # M^-1_ij rr_j
        d = -(Minv * (r * u + dt * p)[None]).sum(1)
        P1 = ((eye * rr[:, :, None] - rr[:, :, None] * Minv * rr[None])
              * inv_dt2 - reg * (K[:, :, None] * K[:, None]).sum(0))
        P1 = P1 + eye * L2[t][:, None]
        if t in slot:
            P1 = P1 + gxx[slot[t]]
        P = torch.where(lower, P1.transpose(0, 1), P1)       # mirror upper
        p = lx[t] - (r * u + rr * d) * inv_dt - reg * (K * d[:, None]).sum(0)
        Ks[t] = K
        ds[t] = d
    return Ks, ds


# ---------------------------------------------------------------------------
# kernel build, checks, launch
# ---------------------------------------------------------------------------

def launch_geometry(B, dtype, n):
    """The launch of the kernel of width n at batch B
    (`nvcc_build.launch_geometry`: blocks, threads, shared memory a block,
    lanes an SM): one thread a lane, a ring of the streamed rows (U, lx, L2
    of STEPS_AHEAD + 1 steps) a lane in shared memory. Needs no card."""
    return nvcc_build.launch_geometry(B, LANES_PER_BLOCK, 1,
                                      (STEPS_AHEAD + 1) * 3 * n,
                                      torch.finfo(dtype).bits // 8)


def _defines(n):
    return (f"SB_N={n}",)


def _entries(n):
    entries = {f"segment_backward_n{n}_{tag}":
               [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
               for tag in ("f32", "f64")}
    entries["segment_backward_geometry"] = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    return entries


def build(n, defines=()):
    """Compile `csrc/segment_backward.cu` at width n for sm_90a (once per
    source content, width and variant `defines`) -> (path of the shared
    library, ptxas report)."""
    return nvcc_build.build(SOURCE, _defines(n) + tuple(defines))


def kernel_geometry(B, dtype, n):
    """What the built kernel of width n itself launches at batch B, asked
    of the library on the card (`nvcc_build.kernel_geometry`);
    `launch_geometry` must agree on blocks, threads and shared memory."""
    fn = nvcc_build.load(SOURCE, _entries(n), _defines(n)).segment_backward_geometry
    return nvcc_build.kernel_geometry(fn, n, torch.finfo(dtype).bits // 8, B)


def _check(P0, p0, L2, lx, U, gxx, kp_steps):
    """Raise on anything the kernel does not take. Needs no card."""
    n = P0.shape[0]
    if P0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_backward kernel takes float32/float64, "
                        f"got {P0.dtype}")
    if not 1 <= n <= MAX_N[P0.dtype]:
        raise ValueError(
            f"segment_backward kernel takes chains of n <= {MAX_N[P0.dtype]} "
            f"joints in {P0.dtype}; got n={n} (ROADMAP Queue 3 F3)")
    B = P0.shape[-1]
    Hm1 = U.shape[0]
    shapes = {"P0": (P0, (n, n, B)), "p0": (p0, (n, B)),
              "L2": (L2, (Hm1, n, B)), "lx": (lx, (Hm1, n, B)),
              "U": (U, (Hm1, n, B)), "gxx": (gxx, (len(kp_steps), n, n, B))}
    for name, (a, shape) in shapes.items():
        if a.device.type != "cuda" or a.device != P0.device:
            raise ValueError(f"segment_backward kernel: {name} must be a CUDA "
                             f"tensor on {P0.device}, got {a.device}")
        if a.dtype != P0.dtype:
            raise TypeError(f"segment_backward kernel: {name} is {a.dtype}, "
                            f"P0 is {P0.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"segment_backward kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"segment_backward kernel: {name} is not contiguous")
    if any(not 0 <= int(k) < Hm1 for k in kp_steps):
        raise ValueError(f"keypoint steps {tuple(kp_steps)} outside [0, {Hm1})")


@functools.lru_cache(maxsize=32)
def _launch_consts(Hm1, kp_steps, dt, reg, Rt, dtype, dev):
    """The kernel's device constants, copied to the card once per solver
    setting: the slot map [Hm1] (-1 off keypoints) and (dt, reg, Rt)."""
    slots = [-1] * Hm1
    for i, k in enumerate(kp_steps):
        slots[k] = i
    return (torch.tensor(slots, dtype=torch.int32, device=dev),
            torch.tensor([dt, reg, *Rt], dtype=dtype, device=dev))


def segment_backward(P0, p0, L2, lx, U, gxx, kp_steps, dt, Rt, reg=1e-6):
    """Full backward sweep -> (Ks [H-1, n, n, B], ds [H-1, n, B]); arguments
    as `segment_backward_reference`. CPU tensors run the twin; CUDA tensors
    launch the kernel on the current stream (n up to `MAX_N`, float32 or
    float64)."""
    global LAUNCHES
    if P0.device.type == "cpu":
        return segment_backward_reference(P0, p0, L2, lx, U, gxx, kp_steps,
                                          dt, Rt, reg)
    _check(P0, p0, L2, lx, U, gxx, kp_steps)
    n, _, B = P0.shape
    Hm1 = U.shape[0]
    dtype, dev = P0.dtype, P0.device
    Ks = torch.empty((Hm1, n, n, B), dtype=dtype, device=dev)
    ds = torch.empty((Hm1, n, B), dtype=dtype, device=dev)
    if B == 0 or Hm1 == 0:
        return Ks, ds
    slots, params = _launch_consts(Hm1, tuple(int(k) for k in kp_steps),
                                   float(dt), float(reg),
                                   tuple(float(v) for v in Rt), dtype, dev)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(nvcc_build.load(SOURCE, _entries(n), _defines(n)),
                 f"segment_backward_n{n}_{tag}")
    with torch.cuda.device(dev):
        err = fn(P0.data_ptr(), p0.data_ptr(), L2.data_ptr(), lx.data_ptr(),
                 U.data_ptr(), gxx.data_ptr(), slots.data_ptr(),
                 params.data_ptr(), Ks.data_ptr(), ds.data_ptr(), Hm1, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_backward kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return Ks, ds
