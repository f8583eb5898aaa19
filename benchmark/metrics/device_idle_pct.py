"""100 x (1 - device busy time of one traced call / the median wall of the
window's untraced calls). Busy time is the union of the intervals of every
device operation of the traced call. The reader of every
`device_idle_pct.<cells>` metric (`device_idle_pct.bulk` for the bulk
cells' calls, `device_idle_pct.replan` for a replan)."""

import statistics


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.device_events:
        return None
    return 100.0 * (1.0 - trace.busy_s / statistics.median(ctx["walls"]))
