"""The program's spans and host syncs in a traced run of a cell.

After the run's own traced call, `measure(ctx)` drives two more calls of
the cell's problem at its shapes, on the run's `--seed`:
  - one under torch.profiler, reduced by `trace_spans`: the program's
    `ilqr::<span>` host ranges are set aside into `SpanTrace.spans`, and
    the device events, `busy_s` and `kernels()` are the card's own work;
  - one untraced, with the program's `SpanRecorder` listening and its host
    sync counter (`SYNCS`) read around it.
It prints one context line, `spans` (each span's count and self time, the
syncs, the share of the recorded call's wall inside `dispatch`, the
profiled call's wall, busy time, device-to-host copies and idle time,
and its idle gaps by the span that left the device idle), and keeps the
readings in `ctx["spans"]` for the readers of the
dispatch, fleet loop, stage terms and sync metrics. A program without the spans and the
counter (`ilqr_planner_torch.utils.compilemeter.SpanRecorder`, `SYNCS`)
gives None and runs nothing, and so does a run without a trace.
"""

import argparse
import bisect
import importlib
import json
import statistics
import sys
import time

import torch

from benchmark import profiling, traffic

PREFIX = "ilqr::"
OUTSIDE = "outside any span"
SYNC = "sync"


def _innermost(spans):
    """Disjoint (start, end, name) segments of the nested `spans`: over
    each, the innermost span open."""
    segs, stack, t = [], [], None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][1] <= x:
            name, end = stack.pop()
            segs.append((t, end, name))
            t = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        if stack:
            segs.append((t, a, stack[-1][0]))
        stack.append((name, b))
        t = a
    close_until(float("inf"))
    return [s for s in segs if s[1] > s[0]]


class SpanTrace(profiling.Trace):
    """A profiled call and the program's spans in it: `spans` are (span
    name, start_s, end_s) on the trace's clock; `host_ops` is empty (the
    spans stand for the host's work)."""

    def __init__(self, device_events, wall_s, profiler_s, spans):
        super().__init__(device_events, [], wall_s, profiler_s)
        self.spans = sorted(spans, key=lambda s: s[1])

    def copies(self):
        """The device-to-host copies: one a host read of a device value."""
        return [e for e in self.device_events if "DtoH" in e[0]]

    def idle_by_span(self):
        """[[span name, seconds]]: the device's idle time between its first
        and last operation. A gap that begins as a device-to-host copy ends
        is a host read's, booked to SYNC; any other, to the innermost span
        open on the host when it began (OUTSIDE where none was). The copy
        marks the reads' gaps on the device's clock alone: such a gap begins
        a few microseconds before the read's span ends, closer than the
        profiler's host and device clocks agree."""
        segs = _innermost(self.spans)
        starts = [a for a, _, _ in segs]
        read_ends = {b for _, _, b in self.copies()}
        by = {}
        for (_, end), (nxt, _) in zip(self.busy, self.busy[1:]):
            i = bisect.bisect_right(starts, end) - 1
            if end in read_ends:
                name = SYNC
            elif i >= 0 and segs[i][1] >= end:
                name = segs[i][2]
            else:
                name = OUTSIDE
            by[name] = by.get(name, 0.0) + (nxt - end)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def reduce_events(events, wall_s, profiler_s):
    """(name, on the device, start_s, end_s) events -> SpanTrace. A device
    event named after a range (the copy the profiler makes of a user
    annotation) is dropped, and so are host events other than the
    ranges."""
    dev, spans = [], []
    for name, on_device, a, b in events:
        mine = name.startswith(PREFIX)
        if on_device and not mine:
            dev.append((name, a, b))
        elif mine and not on_device:
            spans.append((name[len(PREFIX):], a, b))
    return SpanTrace(dev, wall_s, profiler_s, spans)


def trace_spans(fn, device):
    """Run fn() once under torch.profiler (host, and the card's activity
    where `device` is CUDA), synchronized -> SpanTrace. The profiler puts
    the ranges and the device's events on one clock; it also slows the
    host, most where the host issues most launches, and the device idles
    the longer. It reads the profiler's raw events (`kineto_results`): a
    few seconds for a call's 100k kernels, where building torch's event
    tree takes tens."""
    t_all = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        traffic.sync(device)
        wall_s = time.perf_counter() - t0
    res = prof.profiler.kineto_results
    origin = res.trace_start_ns()
    on_device = torch.autograd.DeviceType.CUDA
    events = ((e.name(), e.device_type() == on_device, (e.start_ns() - origin) * 1e-9,
               (e.end_ns() - origin) * 1e-9) for e in res.events())
    tr = reduce_events(events, wall_s, 0.0)
    tr.profiler_s = time.perf_counter() - t_all
    return tr


def _seed():
    """The run's --seed (0 where the command line has none)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _program_meter():
    """The program's compilemeter module, or None where it has no spans."""
    try:
        cm = importlib.import_module("ilqr_planner_torch.utils.compilemeter")
    except ImportError:
        return None
    return cm if hasattr(cm, "SpanRecorder") and hasattr(cm, "SYNCS") else None


def measure(ctx):
    """{"report" ({span: {count, total_s, self_s}} of the recorded call),
    "syncs" (SYNCS over it), "wall_s" (its wall), "trace" (the SpanTrace of
    the profiled call)}, measured once a run and kept in ctx["spans"]; None
    without a trace or without the program's spans."""
    if "trace" not in ctx:
        return None
    if "spans" in ctx:
        return ctx["spans"]
    cm = _program_meter()
    ctx["spans"] = None
    if cm is None:
        return None
    cfg, mix = ctx["config"], ctx["mix"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    problem = importlib.import_module(f"benchmark.problems.{cfg['problem']}")
    call = problem.program_solver(cfg, int(mix["nb_iter"]), device)
    inputs = traffic.Inputs(cfg, dict(mix, pool=1), _seed(), device)

    def one():
        call(inputs.batch(0), inputs.U0)
        traffic.sync(device)

    tr = trace_spans(one, device)
    s0 = cm.SYNCS
    with cm.SpanRecorder() as rec:
        t0 = time.perf_counter()
        one()
        wall_s = time.perf_counter() - t0
    out = {"report": rec.report(), "syncs": cm.SYNCS - s0, "wall_s": wall_s,
           "trace": tr}
    ctx["spans"] = out
    rep, by = out["report"], tr.idle_by_span()
    dispatch = rep.get("dispatch", {}).get("total_s", 0.0)
    print(json.dumps({
        "line": "spans", "recorded_wall_s": wall_s,
        "window_median_s": statistics.median(ctx["walls"]),
        "dispatch_share": dispatch / wall_s, "syncs": out["syncs"],
        "count_self_ms": {k: [v["count"], 1e3 * v["self_s"]] for k, v in rep.items()},
        "traced_wall_s": tr.wall_s, "traced_profiler_s": tr.profiler_s,
        "traced_kernels": len(tr.kernels()), "traced_busy_s": tr.busy_s,
        "traced_copies": len(tr.copies()), "traced_idle_s": sum(v for _, v in by),
        "idle_by_span": by}), flush=True)
    return out


def self_ms(ctx, prefix):
    """Summed self milliseconds of the spans whose name starts with
    `prefix` in the recorded call; None where nothing was measured."""
    m = measure(ctx)
    if m is None:
        return None
    return 1e3 * sum(v["self_s"] for k, v in m["report"].items()
                     if k.startswith(prefix))
