"""One whole call under torch.profiler, reduced to what the per-layer
readers and the breakdown need.

The trace is taken after the measured window, never inside it. Device
events are the kernels, copies and fills that ran on the card; a kernel is
a device event whose name is not a copy or a fill. Times are in seconds.
"""

import bisect
import time

import torch


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _is_kernel(name):
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Trace:
    """The reduced trace of one call."""

    def __init__(self, device_events, host_ops, wall_s, profiler_s):
        self.device_events = device_events      # (name, start_s, end_s)
        self.host_ops = host_ops                # top-level (name, start_s, end_s)
        self.wall_s = wall_s                    # the traced call, host clock
        self.profiler_s = profiler_s            # the whole capture and reduction
        self.busy = _union((a, b) for _, a, b in device_events)
        self.busy_s = sum(b - a for a, b in self.busy)

    def kernels(self, pattern=None):
        """Kernel events, those whose name contains `pattern` if given."""
        return [e for e in self.device_events if _is_kernel(e[0])
                and (pattern is None or pattern in e[0])]

    def mean_ms(self, pattern):
        """Mean device milliseconds of the kernels whose name contains
        `pattern`; None where none ran."""
        events = self.kernels(pattern)
        if not events:
            return None
        return 1e3 * sum(b - a for _, a, b in events) / len(events)

    def device_ops(self, top=10):
        """[[name, seconds]] of the device's busiest operations."""
        by = {}
        for name, a, b in self.device_events:
            by[name[:96]] = by.get(name[:96], 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds]]: the device's idle time
        between its first and last operation, each gap named after the
        top-level host operation running when the gap ended (the one that
        launched the next work, or waited)."""
        starts = [a for _, a, _ in self.host_ops]
        by = {}
        for (_, end), (nxt, _) in zip(self.busy, self.busy[1:]):
            i = bisect.bisect_right(starts, nxt) - 1
            name = "python between operations"
            if i >= 0 and self.host_ops[i][2] >= nxt:
                name = self.host_ops[i][0]
            by[name] = by.get(name, 0.0) + (nxt - end)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def trace_call(fn, device):
    """Run fn() once under torch.profiler (host and device activity),
    synchronized -> Trace."""
    t_all = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, *rng))
        elif e.cpu_parent is None:
            host.append((e.name, *rng))
    host.sort(key=lambda h: h[1])
    return Trace(dev, host, wall_s, time.perf_counter() - t_all)
