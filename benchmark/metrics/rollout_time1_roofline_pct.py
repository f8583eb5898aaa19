"""100 x the least time one H100 could take for one time-optimal trial
rollout at the cell's shapes (`roofline.rollout_bytes` / `rollout_flops`)
over the mean device time of `rollout_kernel` (`rollout_time1`) in the
traced call."""

from benchmark import roofline

KERNEL = "rollout_kernel"


def bound(ctx):
    dof, n, m, inner = ctx["dims"]
    hm1, batch = ctx["config"]["horizon"] - 1, ctx["mix"]["batch"]
    nbytes = roofline.rollout_bytes(n, hm1, batch, 4)
    flops = roofline.rollout_flops(n, hm1, batch)
    return {"kernel": KERNEL, "bytes": nbytes, "flops": flops,
            "bound_ms": roofline.bound_ms(nbytes, flops)}


def read(ctx):
    trace = ctx.get("trace")
    mean_ms = trace.mean_ms(KERNEL) if trace else None
    if mean_ms is None:
        return None
    least_ms, _ = bound(ctx)["bound_ms"]
    return 100.0 * least_ms / mean_ms
