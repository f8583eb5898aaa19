"""Whole-sweep backward pass for the double integrator ('second') and the
sqrt-dt time-optimal first-order kind ('time1'): CUDA kernel, plain twin,
wrapper.

PyTorch counterpart of the JAX package's
`ops/pallas_kernels/segment_backward_2nd.py` (the Pallas TPU kernels
`segment_backward_pallas_2nd` and `segment_backward_pallas_time1`), whose
per-step body is the fleet solver's `_q_terms` + `_gains_value`. The kernels
(`csrc/segment_backward_2nd.cu`) run all H-1 steps in one launch, one
design for both kinds: several threads a scenario lane (a thread a column
of the system: n + 2 for 'second', one of them spare, n + 1 for 'time1'),
the next steps' rows in flight; `launch_geometry` gives the blocks, threads
and shared memory of a launch. Each kind and width is its own library,
built at first use, for any chain up to `MAX_DOF`.
`segment_backward_2nd_reference` is the same
per-step math over [n, n, B] tensors with a Python loop over steps:
`ops/step_terms.py`'s `q_terms` (the Q blocks of the kind's structured A
and B), then its `gains_value` (Gauss-Jordan without pivoting in the JAX
package's elimination order, and the collapsed value update), the functions
the fleet's generic sweep runs too.

The kernel is built with nvcc at first use (`nvcc_build`). The wrappers run
the twin for CPU tensors and the kernel for CUDA tensors; they never fall
back from one to the other, and a width the source cannot take raises
before any build.
"""

import ctypes
import functools

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build
from ilqr_planner_torch.ops.step_terms import gains_value, mirror_upper, q_terms

__all__ = ["segment_backward_2nd", "segment_backward_time1",
           "segment_backward_2nd_reference", "build", "LAUNCHES", "MAX_DOF",
           "widths", "threads_per_lane", "launch_geometry", "kernel_geometry"]

# Kernel launches so far, by kind: one per CUDA call of the kind's wrapper.
LAUNCHES = {"second": 0, "time1": 0}
# The largest chain (DoF) each kind's source takes, by type: the largest
# whose block fits one H100 SM (the threads, the shared memory) and whose
# every width up to it builds without a register spill
# (`python3 tools/width_scan.py`, on the card).
MAX_DOF = {"second": {torch.float32: 11, torch.float64: 7},
           "time1": {torch.float32: 25, torch.float64: 17}}

# The launch constants of `csrc/segment_backward_2nd.cu`, by kind: lanes a
# block, steps whose streamed rows are in flight.
LANES_PER_BLOCK = {"second": 32, "time1": 16}
STEPS_AHEAD = {"second": 2, "time1": 2}

SOURCE = nvcc_build.CSRC / "segment_backward_2nd.cu"


def widths(kind, dof):
    """(n, m) of the kind on a chain of `dof` joints: 'second' (2 dof, dof),
    'time1' (dof + 1, dof + 1)."""
    return (2 * dof, dof) if kind == "second" else (dof + 1, dof + 1)


def threads_per_lane(kind, dof):
    """A thread a column of [Qux | Qu] (n + 1); 'second' has one spare."""
    n = widths(kind, dof)[0]
    return n + 2 if kind == "second" else n + 1


def _smem_values(kind, dof):
    """Values a lane the kind's kernel keeps in shared memory: two carries
    (P in full, p), K | d, the pivot columns with 1 / pivot, the ring of
    streamed rows (U, lx, L2), one keypoint Hessian (upper triangle)."""
    n, m = widths(kind, dof)
    return (2 * (n * n + n) + m * (n + 1) + m * (m + 1)
            + (STEPS_AHEAD[kind] + 1) * (2 * n + m) + n * (n + 1) // 2)


def launch_geometry(kind, B, dtype, dof):
    """The launch of the kind's kernel on a chain of `dof` joints at batch
    B (`nvcc_build.launch_geometry`: blocks, threads, shared memory a block,
    lanes an SM). Needs no card."""
    return nvcc_build.launch_geometry(B, LANES_PER_BLOCK[kind],
                                      threads_per_lane(kind, dof),
                                      _smem_values(kind, dof),
                                      torch.finfo(dtype).bits // 8)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _params(kind, dt, Rt, reg, dtype, dev):
    """(dt, dt^2 / 2, reg, Rt...) rounded once to the working dtype: the
    kernel's parameter vector ('time1' has no fixed step: dt = 0)."""
    dt = 0.0 if kind == "time1" else float(dt)
    return torch.tensor([dt, 0.5 * dt * dt, float(reg), *[float(v) for v in Rt]],
                        dtype=dtype, device=dev)


def segment_backward_2nd_reference(kind, P0, p0, L2, lx, U, gxx, kp_steps, dt,
                                   Rt, reg=1e-6):
    """Full backward sweep -> (Ks [H-1, m, n, B], ds [H-1, m, B]).

    P0 [n, n, B], p0 [n, B]: terminal cost-to-go (upper triangle read).
    L2/lx [H-1, n, B]: the limit diagonal and the stage gradient (keypoint
    -J^T P e folded in); U [H-1, m, B] the controls. gxx [n_kp, n, n, B]:
    dense keypoint Hessians at the steps `kp_steps`. dt is unused for
    'time1'.
    """
    n, _, B = P0.shape
    Hm1, m = U.shape[0], U.shape[1]
    params = _params(kind, dt, Rt, reg, P0.dtype, P0.device)
    dt_t, b1, reg_t, Rt_t = params[0], params[1], params[2], params[3:, None]
    slot = {int(k): i for i, k in enumerate(kp_steps)}
    P, p = mirror_upper(P0), p0
    Ks = P0.new_empty((Hm1, m, n, B))
    ds = P0.new_empty((Hm1, m, B))
    for t in range(Hm1 - 1, -1, -1):
        g = gxx[slot[t]] if t in slot else None
        Q = q_terms(kind, P, p, L2[t], lx[t], U[t], g, dt_t, b1, Rt_t)
        P, p, Ks[t], ds[t] = gains_value(*Q, reg_t)
    return Ks, ds


# ---------------------------------------------------------------------------
# kernel build, checks, launch
# ---------------------------------------------------------------------------

def _width_tag(kind, dof):
    """The kind's width as its library names it: m for 'second', n for
    'time1'."""
    return f"m{dof}" if kind == "second" else f"n{dof + 1}"


def _defines(kind, dof):
    return ((f"SECOND_M={dof}",) if kind == "second"
            else (f"TIME1_N={dof + 1}",))


def _entries(kind, dof):
    entries = {f"segment_backward_{kind}_{_width_tag(kind, dof)}_{tag}":
               [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
               for tag in ("f32", "f64")}
    entries["segment_backward_2nd_geometry"] = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    return entries


def build(kind, dof, defines=()):
    """Compile the kind's kernel of `csrc/segment_backward_2nd.cu` for a
    chain of `dof` joints for sm_90a (once per source content, kind, width
    and design `defines`) -> (path of the shared library, ptxas report)."""
    return nvcc_build.build(SOURCE, _defines(kind, dof) + tuple(defines))


def kernel_geometry(kind, B, dtype, dof):
    """What the built kernel of the kind on a chain of `dof` joints itself
    launches at batch B, asked of the library on the card
    (`nvcc_build.kernel_geometry`); `launch_geometry` must agree on blocks,
    threads and shared memory."""
    lib = nvcc_build.load(SOURCE, _entries(kind, dof), _defines(kind, dof))
    width = dof if kind == "second" else dof + 1
    return nvcc_build.kernel_geometry(lib.segment_backward_2nd_geometry,
                                      ("second", "time1").index(kind), width,
                                      torch.finfo(dtype).bits // 8, B)


def _dof_of(kind, n, m):
    """The chain's DoF behind the widths (n, m), or None where they are not
    the kind's."""
    dof = m if kind == "second" else m - 1
    return dof if dof >= 1 and (n, m) == widths(kind, dof) else None


def _check(kind, P0, p0, L2, lx, U, gxx, kp_steps):
    """Raise on anything the kernel does not take. Needs no card."""
    n, m = P0.shape[0], U.shape[1]
    if P0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_backward_2nd kernel takes float32/float64, "
                        f"got {P0.dtype}")
    dof = _dof_of(kind, n, m)
    top = MAX_DOF[kind][P0.dtype]
    if dof is None or dof > top:
        shape = "(2 dof, dof)" if kind == "second" else "(dof + 1, dof + 1)"
        raise ValueError(
            f"segment_backward_2nd kernel '{kind}' takes (n, m) = {shape} "
            f"for a chain of dof <= {top} joints in {P0.dtype}; got "
            f"({n}, {m}) (ROADMAP Queue 3 F3)")
    B = P0.shape[-1]
    Hm1 = U.shape[0]
    shapes = {"P0": (P0, (n, n, B)), "p0": (p0, (n, B)),
              "L2": (L2, (Hm1, n, B)), "lx": (lx, (Hm1, n, B)),
              "U": (U, (Hm1, m, B)), "gxx": (gxx, (len(kp_steps), n, n, B))}
    for name, (a, shape) in shapes.items():
        if a.device.type != "cuda" or a.device != P0.device:
            raise ValueError(f"segment_backward_2nd kernel: {name} must be a "
                             f"CUDA tensor on {P0.device}, got {a.device}")
        if a.dtype != P0.dtype:
            raise TypeError(f"segment_backward_2nd kernel: {name} is {a.dtype}, "
                            f"P0 is {P0.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"segment_backward_2nd kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"segment_backward_2nd kernel: {name} is not "
                             f"contiguous")
    if any(not 0 <= int(k) < Hm1 for k in kp_steps):
        raise ValueError(f"keypoint steps {tuple(kp_steps)} outside [0, {Hm1})")


@functools.lru_cache(maxsize=32)
def _launch_consts(kind, Hm1, kp_steps, dt, reg, Rt, dtype, dev):
    """The kernel's device constants, copied to the card once per solver
    setting: the slot map [Hm1] (-1 off keypoints) and the parameters."""
    slots = [-1] * Hm1
    for i, k in enumerate(kp_steps):
        slots[k] = i
    return (torch.tensor(slots, dtype=torch.int32, device=dev),
            _params(kind, dt, Rt, reg, dtype, dev))


def _sweep(kind, P0, p0, L2, lx, U, gxx, kp_steps, dt, Rt, reg):
    devices = {a.device for a in (P0, p0, L2, lx, U, gxx)}
    if len(devices) != 1:
        raise ValueError(f"segment_backward_2nd: the arrays lie on more than "
                         f"one device: {sorted(map(str, devices))}")
    if P0.device.type == "cpu":
        return segment_backward_2nd_reference(kind, P0, p0, L2, lx, U, gxx,
                                              kp_steps, dt, Rt, reg)
    _check(kind, P0, p0, L2, lx, U, gxx, kp_steps)
    n, _, B = P0.shape
    Hm1, m = U.shape[0], U.shape[1]
    dtype, dev = P0.dtype, P0.device
    Ks = torch.empty((Hm1, m, n, B), dtype=dtype, device=dev)
    ds = torch.empty((Hm1, m, B), dtype=dtype, device=dev)
    if B == 0 or Hm1 == 0:
        return Ks, ds
    slots, params = _launch_consts(kind, Hm1, tuple(int(k) for k in kp_steps),
                                   None if dt is None else float(dt),
                                   float(reg), tuple(float(v) for v in Rt),
                                   dtype, dev)
    dof = _dof_of(kind, n, m)
    tag = "f32" if dtype == torch.float32 else "f64"
    lib = nvcc_build.load(SOURCE, _entries(kind, dof), _defines(kind, dof))
    fn = getattr(lib, f"segment_backward_{kind}_{_width_tag(kind, dof)}_{tag}")
    with torch.cuda.device(dev):
        err = fn(P0.data_ptr(), p0.data_ptr(), L2.data_ptr(), lx.data_ptr(),
                 U.data_ptr(), gxx.data_ptr(), slots.data_ptr(),
                 params.data_ptr(), Ks.data_ptr(), ds.data_ptr(), Hm1, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_backward_2nd kernel '{kind}' launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    return Ks, ds


def segment_backward_2nd(P0, p0, L2, lx, U, gxx, kp_steps, dt, Rt, reg=1e-6):
    """Double-integrator sweep -> (Ks [H-1, m, n, B], ds [H-1, m, B]);
    arguments as `segment_backward_2nd_reference`. CPU tensors run the twin;
    CUDA tensors launch the kernel (n = 2m, m up to `MAX_DOF`, float32 or
    float64)."""
    return _sweep("second", P0, p0, L2, lx, U, gxx, kp_steps, dt, Rt, reg)


def segment_backward_time1(P0, p0, L2, lx, U, gxx, kp_steps, Rt, reg=1e-6):
    """Time-optimal first-order sweep (n = m = dof + 1, the step durations
    s^2 read from U); CPU tensors run the twin, CUDA tensors launch the
    kernel (n = m up to `MAX_DOF` + 1, float32 or float64)."""
    return _sweep("time1", P0, p0, L2, lx, U, gxx, kp_steps, None, Rt, reg)
