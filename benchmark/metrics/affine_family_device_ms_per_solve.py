"""Summed device milliseconds of the affine-family kernel in one whole
traced bulk call: `affine_family_kernel`
(`ilqr_planner_torch/csrc/affine_family.cu`), one launch a line search of
the LTI kinds, and no other kernel; None where none ran."""

KERNEL = "affine_family_"


def read(ctx):
    trace = ctx.get("trace")
    events = trace.kernels(KERNEL) if trace else []
    if not events:
        return None
    return 1e3 * sum(b - a for _, a, b in events)
