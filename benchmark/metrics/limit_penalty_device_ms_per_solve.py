"""Summed device milliseconds of the joint-limit penalty kernel in one whole
traced bulk call: both forms, `limit_penalty_cost_kernel` and
`limit_penalty_arrays_kernel` (`ilqr_planner_torch/csrc/limit_penalty.cu`),
and no other kernel; None where none ran."""

KERNEL = "limit_penalty_"


def read(ctx):
    trace = ctx.get("trace")
    events = trace.kernels(KERNEL) if trace else []
    if not events:
        return None
    return 1e3 * sum(b - a for _, a, b in events)
