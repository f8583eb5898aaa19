"""The least time one H100 could take for a kernel's work: the yardstick of
every `<kernel>_roofline` metric.

Frozen copies of the operation and byte counts that the port's kernels were
designed against (`chip_smoke.py` at the time the benchmark was defined),
so that a later change to the program cannot move the yardstick. Each count
is computed from shapes alone: every input read once, every output written
once, and each add, multiply, divide or square root of the kernel's loops
one operation.
"""

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM bytes/s,
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def sweep_flops(n, hm1, n_kp, batch):
    """Operations of one first-order sweep (`segment_backward`): Cholesky,
    inverse, gains and the value update a step, and the dense keypoint
    Hessians' upper triangles."""
    chol = sum(2 * j + 5 + (n - j - 1) * (2 * j + 3) for j in range(n))
    minv = sum(sum(2 * (i - c) + 2 for i in range(c + 1, n))
               + sum(2 * (n - 1 - i) + 2 for i in range(c, n))
               for c in range(n))
    d = 3 * n + n * 2 * n + n
    K = 3 * n * n
    P1 = n * (n + 1) // 2 * (2 * n + 6) + n
    p1 = n * (2 * n + 7)
    per_step = chol + minv + d + K + P1 + p1
    return batch * (hm1 * per_step + n_kp * n * (n + 1) // 2)


def sweep_bytes(n, hm1, n_kp, batch, itemsize, m=None):
    """Bytes of one sweep: each input read once, each output written once;
    the upper triangles of P0 and of each keypoint Hessian. m=None is the
    first-order sweep (m = n; parameters dt, reg, Rt), else the 2nd-order or
    time-optimal one (parameters dt, dt^2/2, reg, Rt)."""
    n_params = 2 + n if m is None else 3 + m
    m = n if m is None else m
    tri = n * (n + 1) // 2
    vals = (tri + n + hm1 * (2 * n + m) + n_kp * tri    # P0, p0, L2/lx/U, gxx
            + hm1 * m * n + hm1 * m)                    # Ks, ds
    return batch * vals * itemsize + hm1 * 4 + n_params * itemsize


def rollout_flops(n, hm1, batch):
    """Operations of one time-optimal closed-loop rollout (`rollout_time1`)."""
    m, dof = n, n - 1
    per_step = n + m * (2 * n + 2 + 2 + 1) + 1 + 2 * dof + 1
    return batch * hm1 * per_step


def rollout_bytes(n, hm1, batch, itemsize):
    """Each input read once (gains, d, xo, uo per step and x0), each output
    written once (X with its row 0, U, ||du||^2)."""
    m = n
    vals = n + hm1 * (m * n + m + n + m) + (hm1 + 1) * n + hm1 * m + hm1
    return batch * vals * itemsize


def bound_ms(nbytes, flops):
    """-> (least milliseconds, "bytes" or "operations": which peak binds)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
