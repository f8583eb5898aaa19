"""100 x the least time one H100 could take for one first-order backward
sweep at the cell's shapes (`roofline.sweep_bytes` / `sweep_flops`) over
the mean device time of `segment_backward_kernel` in the traced call."""

from benchmark import roofline

KERNEL = "segment_backward_kernel"


def bound(ctx):
    dof, n, m, inner = ctx["dims"]
    hm1, batch = ctx["config"]["horizon"] - 1, ctx["mix"]["batch"]
    nbytes = roofline.sweep_bytes(n, hm1, inner, batch, 4)
    flops = roofline.sweep_flops(n, hm1, inner, batch)
    return {"kernel": KERNEL, "bytes": nbytes, "flops": flops,
            "bound_ms": roofline.bound_ms(nbytes, flops)}


def read(ctx):
    trace = ctx.get("trace")
    mean_ms = trace.mean_ms(KERNEL) if trace else None
    if mean_ms is None:
        return None
    least_ms, _ = bound(ctx)["bound_ms"]
    return 100.0 * least_ms / mean_ms
