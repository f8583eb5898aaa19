"""100 x the device's idle time that host syncs leave (the gaps that
begin as the copy of a host read ends: `spans.SpanTrace.idle_by_span`)
in the call `spans.measure` profiles, over that call's wall. The profiler
slows that call's host, so its idle is longer than the window's, and the
more so where the host issues more launches: the share is the profiled
call's."""

from benchmark import spans


def read(ctx):
    m = spans.measure(ctx)
    if m is None or not m["trace"].device_events:
        return None
    tr = m["trace"]
    return 100.0 * dict(tr.idle_by_span()).get(spans.SYNC, 0.0) / tr.wall_s
