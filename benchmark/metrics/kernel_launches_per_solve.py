"""Kernel launches in one whole traced bulk call (profiler kernel events)."""


def read(ctx):
    trace = ctx.get("trace")
    return float(len(trace.kernels())) if trace else None
