"""Summed device milliseconds of the keypoint-cost kernel in one whole
traced bulk call: `kp_cost_kernel` (`ilqr_planner_torch/csrc/kp_cost.cu`),
both forms, and no other kernel; None where none ran."""

KERNEL = "kp_cost_"


def read(ctx):
    trace = ctx.get("trace")
    events = trace.kernels(KERNEL) if trace else []
    if not events:
        return None
    return 1e3 * sum(b - a for _, a, b in events)
