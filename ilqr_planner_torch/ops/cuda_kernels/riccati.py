"""Fused dense quadratization + Riccati backward sweep of the recursive
solver's structured first-order kinds: CUDA kernel, plain twin, wrapper.

PyTorch counterpart of the JAX package's `ops/pallas_kernels/riccati.py`
(the Pallas TPU kernel `riccati_backward_structured` and its plain
`riccati_backward_reference`). For A = I, B = dt I it computes, at EVERY
step, the Gauss-Newton stage terms l_xx = J^T prec J + diag(ld^2),
l_x = -J^T prec e - ld lq, and folds them into the value recursion with the
explicit Gauss-Jordan inverse (no pivoting) of Quu + reg I:
K = -M^-1 Qux, d = -M^-1 Qu, and the value update with the UNregularized
Quu. It is the backward pass `solvers/ilqr.py::_backward` hands these kinds.

Arrays are batch-leading, the JAX function's own layout and the one the
recursive solver produces, and nothing is transposed around the launch:
the kernel (`csrc/riccati.cu`) stages each step's [lanes, values] rows
through shared memory instead of asking for a lane-minor copy. Any B >= 0 is
taken (the TPU kernel's multiple-of-128 lane tiles are not carried over).

  J  [B, H, nq, n]   residual Jacobians per step
  e  [B, H, nq]      residuals (keypoint-masked)
  ld [B, H, n]       limit-penalty diagonal; lq [B, H, n] violations
  u  [B, H-1, n]     controls
  prec [H, nq, nq]   precisions (the same for every lane)
  Rt [n], dt, reg    control penalty diagonal, time step, ridge
  -> K [B, H-1, n, n], d [B, H-1, n]

`riccati_backward` runs the twin for CPU tensors and the kernel for CUDA
tensors (any chain n up to `MAX_N` and any residual width nq up to
`MAX_NQ`: 6 posorn, n joint, 3 point, 2 planar point, and their sums in a
sequential spec; float32 or float64); it never falls back from one to the
other, and a width the source cannot take raises before any build. Each
width is its own library, built at first use. The kernel
runs n + 1 threads a scenario lane (a thread a column of the system, one for
the vectors) and stages the next step's inputs while a step is computed;
`launch_geometry` gives the blocks, threads and shared memory of a launch.
"""

import ctypes
import functools

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["riccati_backward", "riccati_backward_reference", "build",
           "LAUNCHES", "MAX_N", "MAX_NQ", "residual_widths", "launch_geometry",
           "kernel_geometry"]

# Kernel launches so far: one per CUDA call of `riccati_backward`.
LAUNCHES = 0
# The largest chain n the source takes, by type: the largest whose block
# fits one H100 SM (n + 1 threads a lane; the shared memory at nq =
# max(6, n)) and whose every width up to it builds without a register spill
# (`python3 tools/width_scan.py`, on the card).
MAX_N = {torch.float32: 11, torch.float64: 7}
# The launch constants of `csrc/riccati.cu`: lanes a block, steps a staged
# chunk of inputs (a lane runs n + 1 threads).
LANES_PER_BLOCK = 32
STEPS_PER_CHUNK = 1

SOURCE = nvcc_build.CSRC / "riccati.cu"


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _gauss_jordan_inv(M):
    """Explicit inverse of M [..., n, n] by Gauss-Jordan without pivoting,
    in the TPU body's order: scale the pivot row, eliminate every other."""
    n = M.shape[-1]
    A = M.clone()
    inv = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(M).clone()
    for k in range(n):
        piv = (1.0 / A[..., k, k])[..., None]
        row_a = A[..., k, :] * piv
        row_i = inv[..., k, :] * piv
        f = A[..., :, k].clone()
        f[..., k] = 0.0
        A = A - f[..., None] * row_a[..., None, :]
        inv = inv - f[..., None] * row_i[..., None, :]
        A[..., k, :] = row_a
        inv[..., k, :] = row_i
    return inv


def _mv(A, v):
    return (A * v[..., None, :]).sum(-1)


def riccati_backward_reference(J, e, ld, lq, u, prec, Rt, dt, reg=1e-6):
    """Structured backward sweep in plain tensor ops -> (K [B, H-1, n, n],
    d [B, H-1, n]), following the TPU kernel's body term by term. dt, reg
    and Rt enter in the working dtype, as the kernel receives them."""
    B, H, nq, n = J.shape
    dtype, dev = J.dtype, J.device
    params = torch.tensor([dt, reg, *[float(v) for v in Rt]], dtype=dtype,
                          device=dev)
    dt, reg, r = params[0], params[1], params[2:]
    prec = prec.to(dtype)
    eye = torch.eye(n, dtype=dtype, device=dev)

    Jt = J.transpose(-1, -2)
    lxx = Jt @ (prec @ J) + torch.diag_embed(ld * ld)
    lx = -_mv(Jt, _mv(prec, e)) - ld * lq

    P, p = lxx[:, H - 1], lx[:, H - 1]
    K = torch.empty((B, H - 1, n, n), dtype=dtype, device=dev)
    d = torch.empty((B, H - 1, n), dtype=dtype, device=dev)
    for t in range(H - 2, -1, -1):
        Quu_reg = dt * dt * P + torch.diag(r + reg)
        Qux = dt * P
        Qu = r * u[:, t] + dt * p
        Qx = lx[:, t] + p
        negM = -_gauss_jordan_inv(Quu_reg)
        Kt = negM @ Qux
        dk = _mv(negM, Qu)
        # the value recursion uses the UNregularized Quu
        Quu = Quu_reg - reg * eye
        KT = Kt.transpose(-1, -2)
        QxuT = Qux.transpose(-1, -2)
        KTQ = KT @ Quu
        P = lxx[:, t] + P + KTQ @ Kt + KT @ Qux + QxuT @ Kt
        p = Qx + _mv(KTQ, dk) + _mv(KT, Qu) + _mv(QxuT, dk)
        K[:, t] = Kt
        d[:, t] = dk
    return K, d


# ---------------------------------------------------------------------------
# kernel build, checks, launch
# ---------------------------------------------------------------------------

def residual_widths(n):
    """The residual widths nq of the single kinds on a chain of n joints:
    position + orientation, joint, point. A sequential spec sums its
    subsystems' widths; the kernel takes any nq up to `MAX_NQ`."""
    return (6, n, 3)


def _smem_values(n, nq):
    """Values a lane the kernel keeps in shared memory: two staged input
    chunks and the gains' chunk (each a lane's row, its length made odd),
    two carries (P in full, p), the pivot columns, and the chunk's
    precisions (two buffers a block, spread over the lanes)."""
    S, L = STEPS_PER_CHUNK, LANES_PER_BLOCK
    tile_in = S * (nq * n + nq + 3 * n) | 1
    tile_out = S * (n * n + n) | 1
    prec = -(-2 * S * nq * nq // L)
    return 2 * tile_in + tile_out + 2 * (n * n + n) + n * (n + 1) + prec


def launch_geometry(B, dtype, n, nq):
    """The launch of the kernel of width (n, nq) at batch B
    (`nvcc_build.launch_geometry`: blocks, threads, shared memory a block,
    lanes an SM). Needs no card."""
    return nvcc_build.launch_geometry(B, LANES_PER_BLOCK, n + 1,
                                      _smem_values(n, nq), torch.finfo(dtype).bits // 8)


def _fit_nq(dtype):
    """The widest residual nq whose block fits one H100 SM at the type's
    widest chain `MAX_N` (the precisions are nq * nq values a step, so the
    shared memory grows with nq; the threads do not)."""
    nq = 0
    while (launch_geometry(1, dtype, MAX_N[dtype], nq + 1)["smem_bytes"]
           <= nvcc_build.SMEM_PER_BLOCK_MAX):
        nq += 1
    return nq


# The widest residual nq the source takes, by type: the block's fit at
# MAX_N (float32 45, float64 35), so every nq up to it fits at every n up
# to MAX_N. No spill-free limit exists: ptxas spills at scattered widths
# from nq = 8 on (`python3 tools/width_scan.py riccati_nq`, on the card,
# builds every width up to the limit and times a spill), a cost in time,
# not in the result.
MAX_NQ = {dtype: _fit_nq(dtype) for dtype in MAX_N}


def _defines(n, nq):
    return (f"RICCATI_N={n}", f"RICCATI_NQ={nq}")


def _entries(n, nq):
    entries = {f"riccati_backward_{n}x{nq}_{tag}":
               [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
               for tag in ("f32", "f64")}
    entries["riccati_geometry"] = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    return entries


def build(n, nq, defines=()):
    """Compile `csrc/riccati.cu` at width (n, nq) for sm_90a (once per
    source content, width and design `defines`) -> (path of the shared
    library, ptxas report)."""
    return nvcc_build.build(SOURCE, _defines(n, nq) + tuple(defines))


def kernel_geometry(B, dtype, n, nq):
    """What the built kernel of width (n, nq) itself launches at batch B,
    asked of the library on the card (`nvcc_build.kernel_geometry`);
    `launch_geometry` must agree on blocks, threads and shared memory."""
    fn = nvcc_build.load(SOURCE, _entries(n, nq), _defines(n, nq)).riccati_geometry
    return nvcc_build.kernel_geometry(fn, n, nq, torch.finfo(dtype).bits // 8, B)


def _check(J, e, ld, lq, u, prec):
    """Raise on anything the kernel does not take. Needs no card."""
    B, H, nq, n = J.shape
    if J.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"riccati kernel takes float32/float64, got {J.dtype}")
    if not 1 <= nq <= MAX_NQ[J.dtype]:
        raise ValueError(
            f"riccati kernel takes residual widths 1 <= nq <= "
            f"{MAX_NQ[J.dtype]} in {J.dtype}; got nq={nq}")
    if not 1 <= n <= MAX_N[J.dtype]:
        raise ValueError(
            f"riccati kernel takes chains of n <= {MAX_N[J.dtype]} joints in "
            f"{J.dtype}; got n={n} (ROADMAP Queue 3 F3)")
    shapes = {"J": (J, (B, H, nq, n)), "e": (e, (B, H, nq)),
              "ld": (ld, (B, H, n)), "lq": (lq, (B, H, n)),
              "u": (u, (B, H - 1, n)), "prec": (prec, (H, nq, nq))}
    for name, (a, shape) in shapes.items():
        if a.device.type != "cuda" or a.device != J.device:
            raise ValueError(f"riccati kernel: {name} must be a CUDA tensor "
                             f"on {J.device}, got {a.device}")
        if a.dtype != J.dtype:
            raise TypeError(f"riccati kernel: {name} is {a.dtype}, J is "
                            f"{J.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"riccati kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"riccati kernel: {name} is not contiguous")


@functools.lru_cache(maxsize=32)
def _params(dt, reg, Rt, dtype, dev):
    """(dt, reg, Rt) on the card, copied once per solver setting."""
    return torch.tensor([dt, reg, *Rt], dtype=dtype, device=dev)


def riccati_backward(J, e, ld, lq, u, prec, Rt, dt, reg=1e-6):
    """Structured backward sweep -> (K [B, H-1, n, n], d [B, H-1, n]);
    arguments as `riccati_backward_reference`. CPU tensors run the twin;
    CUDA tensors launch the kernel on the current stream (n up to `MAX_N`,
    nq up to `MAX_NQ`, float32 or float64, any B). A horizon H < 2
    raises."""
    global LAUNCHES
    if J.dim() != 4 or J.shape[1] < 2:
        raise ValueError(f"riccati_backward needs J [B, H, nq, n] with a "
                         f"horizon H >= 2; got J of shape {tuple(J.shape)}")
    devices = {a.device for a in (J, e, ld, lq, u, prec)}
    if len(devices) != 1:
        raise ValueError(f"riccati_backward: the arrays lie on more than one "
                         f"device: {sorted(map(str, devices))}")
    if J.device.type == "cpu":
        return riccati_backward_reference(J, e, ld, lq, u, prec, Rt, dt, reg)
    _check(J, e, ld, lq, u, prec)
    B, H, nq, n = J.shape
    dtype, dev = J.dtype, J.device
    K = torch.empty((B, H - 1, n, n), dtype=dtype, device=dev)
    d = torch.empty((B, H - 1, n), dtype=dtype, device=dev)
    if B == 0:
        return K, d
    params = _params(float(dt), float(reg), tuple(float(v) for v in Rt),
                     dtype, dev)
    tag = "f32" if dtype == torch.float32 else "f64"
    lib = nvcc_build.load(SOURCE, _entries(n, nq), _defines(n, nq))
    fn = getattr(lib, f"riccati_backward_{n}x{nq}_{tag}")
    with torch.cuda.device(dev):
        err = fn(J.data_ptr(), e.data_ptr(), ld.data_ptr(), lq.data_ptr(),
                 u.data_ptr(), prec.data_ptr(), params.data_ptr(),
                 K.data_ptr(), d.data_ptr(), H, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"riccati kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return K, d
