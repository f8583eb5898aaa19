"""The affine trial family of the fleet solver's line search in one CUDA
launch: kernel, plain twin, wrapper.

No TPU kernel stands behind it: the JAX package writes the family as a
scan of jnp operations (`solvers/fleet.py::_affine_family`), which XLA
fuses. For the LTI kinds, the first order (n = m) and the double integrator
(n = 2m), the closed-loop trial of step size alpha is affine in alpha:
X(alpha) = Xb + alpha Xd, U(alpha) = Ub + alpha Ud, and
||du_k(alpha)||^2 = qa_k + 2 alpha qb_k + alpha^2 qc_k. One pass over the
horizon gives the base (alpha = 0) and the direction together:
    dub = K (xb - xo),   dud = K xd + d,   ub = uo + dub,
and the dynamics' update of both (x + dt v, or the double integrator's
semi-implicit Euler). `affine_family_reference` is that pass in tensor ops
with a Python loop over steps, as the fleet ran it before the kernel (its
twin: the fleet runs it on the CPU). The kernel (`csrc/affine_family.cu`)
runs m threads a lane (a warp a row of the gains), base and direction in
registers, the inputs of the next steps in flight through a ring in shared
memory (`launch_geometry`), and writes row 0 itself, so a family is one
launch. It is one library a width (n, m), built at first use. The wrapper
takes CUDA tensors only and raises on anything it cannot take; the fleet
(`solvers/fleet.py::_affine_family`) chooses between it and the twin.
"""

import ctypes

import torch

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build

__all__ = ["affine_family", "affine_family_reference", "build", "LAUNCHES",
           "MAX_M", "launch_geometry", "kernel_geometry"]

# Kernel launches so far: one per call of `affine_family`.
LAUNCHES = 0

# The launch constants of `csrc/affine_family.cu`: lanes a block, step tiles
# in the shared-memory ring (a lane runs m threads, one a row of the gains).
LANES_PER_BLOCK = 32
RING_STAGES = 6

SOURCE = nvcc_build.CSRC / "affine_family.cu"


def _tile_rows(n, m):
    """Rows of a step's tile: the gains, d, xo and uo."""
    return m * n + 2 * m + n


def launch_geometry(B, dtype, n, m):
    """The kernel's launch at width (n, m) and batch B
    (`nvcc_build.launch_geometry`: blocks, threads, shared memory a block,
    lanes an SM). Needs no card."""
    # a step's tile in each ring stage; ub, dub and dud of two steps
    values = RING_STAGES * _tile_rows(n, m) + 6 * m
    return nvcc_build.launch_geometry(B, LANES_PER_BLOCK, m, values,
                                      torch.finfo(dtype).bits // 8)


def _max_m(second, dtype):
    m = 1
    while launch_geometry(1, dtype, 2 * (m + 1) if second else m + 1,
                          m + 1)["smem_bytes"] <= nvcc_build.SMEM_PER_BLOCK_MAX:
        m += 1
    return m


# The widest control m the source takes, by (double integrator, type): the
# widest whose block fits one H100 SM.
MAX_M = {(second, dtype): _max_m(second, dtype) for second in (False, True)
         for dtype in (torch.float32, torch.float64)}


def affine_family_reference(Ks, ds, Xref, Uref, x0, dt, second_order):
    """The exact affine trial family -> (Xb, Xd [H, n, B], Ub, Ud
    [H-1, m, B], qa, qb, qc [H-1, B]), with ||du_k(alpha)||^2 =
    qa_k + 2 alpha qb_k + alpha^2 qc_k.

    Ks [H-1, m, n, B], ds/Uref [H-1, m, B], Xref [H, n, B] (rows 0..H-2
    read), x0 [n, B]; dt a float; second_order: the double integrator
    (n = 2m), else first order (n = m). Base (alpha = 0) and direction are
    carried together as [2, n, B]: the direction's reference state and
    control are zero, so one product with K serves both."""
    Hm1, m = Ks.shape[0], Ks.shape[1]
    H, dof = Hm1 + 1, m
    B = x0.shape[-1]
    zX = torch.zeros_like(Xref[:-1])
    ref_x = torch.stack([Xref[:-1], zX], dim=1)            # [H-1, 2, n, B]
    ref_u = torch.stack([Uref, torch.zeros_like(Uref)], dim=1)
    Xbd = x0.new_empty((H, 2) + tuple(x0.shape))
    Xbd[0, 0] = x0
    Xbd[0, 1] = 0.0
    DU = x0.new_empty((H - 1, 2, m, B))
    xbd = Xbd[0]
    for k in range(H - 1):
        du = (Ks[k][None] * (xbd - ref_x[k])[:, None]).sum(2)  # [2, m, B]
        du[1] += ds[k]
        DU[k] = du
        v = du + ref_u[k]
        if second_order:
            # semi-implicit Euler, on the base and (linearly) the direction
            q, dq = xbd[:, :dof], xbd[:, dof:]
            xbd = torch.cat([q + dt * dq + (0.5 * dt * dt) * v, dq + dt * v],
                            dim=1)
        else:
            xbd = xbd + dt * v
        Xbd[k + 1] = xbd
    dub, dud = DU[:, 0], DU[:, 1]
    return (Xbd[:, 0], Xbd[:, 1], Uref + dub, dud, (dub * dub).sum(1),
            (dub * dud).sum(1), (dud * dud).sum(1))


def _defines(n, m):
    return (f"AF_N={n}", f"AF_M={m}")


def _entries(n, m):
    entries = {f"affine_family_n{n}_m{m}_{tag}": [ctypes.c_void_p] * 5
               + [real] * 2 + [ctypes.c_void_p] * 7
               + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
               for tag, real in (("f32", ctypes.c_float),
                                 ("f64", ctypes.c_double))}
    entries["affine_family_geometry"] = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    return entries


def build(n, m):
    """Compile `csrc/affine_family.cu` at width (n, m) for sm_90a (once per
    source content and width) -> (path of the shared library, ptxas
    report)."""
    return nvcc_build.build(SOURCE, _defines(n, m))


def kernel_geometry(B, dtype, n, m):
    """What the built kernel of width (n, m) itself launches at batch B,
    asked of the library on the card (`nvcc_build.kernel_geometry`);
    `launch_geometry` must agree on blocks, threads and shared memory."""
    fn = nvcc_build.load(SOURCE, _entries(n, m),
                         _defines(n, m)).affine_family_geometry
    return nvcc_build.kernel_geometry(fn, n, m, torch.finfo(dtype).bits // 8, B)


def _check(Ks, ds, Xref, Uref, x0, second_order):
    """Raise on anything the kernel does not take, the device last. Needs no
    card."""
    if Ks.dim() != 4 or Ks.shape[0] < 1:
        raise ValueError(f"affine_family needs gains Ks [H-1, m, n, B] with a "
                         f"horizon H >= 2; got Ks of shape {tuple(Ks.shape)}")
    Hm1, m, n, B = Ks.shape
    if Ks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"affine_family kernel takes float32/float64, got "
                        f"{Ks.dtype}")
    if n != (2 * m if second_order else m):
        raise ValueError(f"affine_family kernel takes n = {'2m' if second_order else 'm'} "
                         f"({'double integrator' if second_order else 'first order'}); "
                         f"got n={n}, m={m}")
    top = MAX_M[(bool(second_order), Ks.dtype)]
    if m > top:
        raise ValueError(f"affine_family kernel takes m up to {top} in "
                         f"{Ks.dtype} here (the block's fit); got m={m}")
    shapes = {"Ks": (Ks, (Hm1, m, n, B)), "ds": (ds, (Hm1, m, B)),
              "Xref": (Xref, (Hm1 + 1, n, B)), "Uref": (Uref, (Hm1, m, B)),
              "x0": (x0, (n, B))}
    for name, (a, shape) in shapes.items():
        if a.dtype != Ks.dtype:
            raise TypeError(f"affine_family kernel: {name} is {a.dtype}, Ks is "
                            f"{Ks.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"affine_family kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"affine_family kernel: {name} is not contiguous")
    for name, (a, _) in shapes.items():
        if a.device.type != "cuda" or a.device != Ks.device:
            raise ValueError(f"affine_family kernel takes CUDA tensors on one "
                             f"device: {name} is on {a.device}, Ks on "
                             f"{Ks.device}")


def affine_family(Ks, ds, Xref, Uref, x0, dt, second_order):
    """The affine trial family in one launch on the current stream ->
    (Xb, Xd, Ub, Ud, qa, qb, qc), each contiguous; arguments and results as
    `affine_family_reference`. CUDA tensors only, float32 or float64, m up
    to `MAX_M`."""
    global LAUNCHES
    _check(Ks, ds, Xref, Uref, x0, second_order)
    Hm1, m, n, B = Ks.shape
    Xb = Ks.new_empty((Hm1 + 1, n, B))
    Xd = torch.empty_like(Xb)
    Ub = Ks.new_empty((Hm1, m, B))
    Ud = torch.empty_like(Ub)
    q = Ks.new_empty((3, Hm1, B))
    if B == 0:
        return Xb, Xd, Ub, Ud, q[0], q[1], q[2]
    tag = "f32" if Ks.dtype == torch.float32 else "f64"
    fn = getattr(nvcc_build.load(SOURCE, _entries(n, m), _defines(n, m)),
                 f"affine_family_n{n}_m{m}_{tag}")
    dev = Ks.device
    with torch.cuda.device(dev):
        err = fn(Ks.data_ptr(), ds.data_ptr(), Xref.data_ptr(), Uref.data_ptr(),
                 x0.data_ptr(), float(dt), 0.5 * dt * dt, Xb.data_ptr(),
                 Xd.data_ptr(), Ub.data_ptr(), Ud.data_ptr(), q[0].data_ptr(),
                 q[1].data_ptr(), q[2].data_ptr(), Hm1, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_family kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return Xb, Xd, Ub, Ud, q[0], q[1], q[2]
