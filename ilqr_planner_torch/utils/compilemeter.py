"""The port's spans and host-sync counter, and the meters that listen to
them.

A span is a named interval of the host's work, opened at the site where
the work happens (`with span(name):`, or `@spanned(name)` on a function).
The port's names:

    solver_build      a solver memo miss in `parallel/mesh.py` (the fleet's
                      host constants), and a kernel wrapper's per-setting
                      device constants copied to the card on a cache miss;
    nvcc              one nvcc run (`ops/cuda_kernels/nvcc_build.build`),
                      only when the library is not already built;
    load              `ctypes.CDLL` of a built library and its argument
                      types (`nvcc_build.load`);
    dispatch          the body of `parallel/mesh.py::solve_batch` and
                      `solve_batch_al` (the spec's fingerprint, the memo,
                      the route, the solve);
    fleet.iteration   one pass of a fleet solve's iteration loop, its guard
                      included;
    fleet.backward    `fleet._backward` (a sweep kernel's wrapper inside);
    fleet.line_search `fleet._run_trials_affine` / `_run_trials`;
    fleet.rollout     `fleet._rollout` (the initial rollout and each
                      time-optimal trial);
    stage_terms       `fleet._kp_terms_at`, `_limit_arrays`,
                      `_limit_cost_full`, `_kp_cost`, `_fx_traj`;
    sync              one host read of a device value (`host_read`).

`SYNCS` counts the host reads of device values the solvers make
(`host_read`): the fleet's loop and trial guards, the recursive routes'
guards, and one a tensor that `mesh._digest` copies to the host to
fingerprint a spec. On a card each blocks until the device's queue drains.

Listeners hear the spans closed on any thread while they are inside
their `with` block:

    with SpanRecorder() as rec:        # every span
        solve_batch(...)
    rec.report()   # {name: {"count", "total_s", "self_s"}}
    rec.spans()    # SpanRecord(name, start_s, end_s, id, parent, call, self_s)

    with CompileMeter() as cm:         # solver_build, nvcc and load only
        first_call()
    cm.report(wall_s=...)

A span's self time is its interval less the spans nested inside it on the
same thread, so the self times of one call add up to its outermost span.
`parent` is the id of the span it is nested in (None for an outermost
one), `call` the id of the outermost span open around it: every span of
one `solve_batch` call shares it. Times are `time.perf_counter()` seconds.

While torch's profiler is on (`utils.trace`, `torch.profiler.profile`),
each span is also a profiler range named `ilqr::<name>` on the host's
timeline, beside the torch operations it runs and on the clock of the
card's kernels. The range is a plain host operation, not a user
annotation, so the profiler does not copy it onto the device's timeline
and the trace's device events stay the card's own work.

While no listener and no profiler is on, a span costs one check.
Listeners are guarded by a lock: libraries are built from many threads at
once.

`CompileMeter` attributes a first call's time: nothing is counted twice.
Each `<name>_s` is the wall time during which at least one span of that
name ran on its own time: the union of their self intervals, so builds
running on several threads at once count their overlap once;
`nvcc_sum_s` is the sum of the nvcc runs' own times (above `nvcc_s` when
builds run in parallel). `other_s` is `wall_s` less the union of every
metered span's interval, so it is never negative. Spans of two names on
two threads may overlap: the names' times may then add to more than that
union. CUDA's own first-call costs are in no span and fall to `other_s`:
creating the context, lazy-loading PyTorch's kernel modules, the caching
allocator's first blocks (a first copy to the card inside a solver build
pays for these there).
"""

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["CompileMeter", "SpanRecorder", "SpanRecord", "SYNCS", "host_read",
           "span", "spanned"]

SYNCS = 0

_NAMES = ("solver_build", "nvcc", "load")
_COUNTS = {"solver_build": "solver_builds", "nvcc": "compiles",
           "load": "loads"}

SpanRecord = collections.namedtuple(
    "SpanRecord", "name start_s end_s id parent call self_s")

_lock = threading.Lock()
_listening = []                 # listeners inside their `with` block
_local = threading.local()      # this thread's open spans
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()
# a host-only profiler range: unlike record_function's user annotation, the
# profiler makes no copy of it on the device's timeline
_range = torch._C._profiler._RecordFunctionFast


def _subtract(iv, holes):
    """The interval iv less the disjoint, ordered intervals `holes` inside
    it -> a list of intervals."""
    out, t = [], iv[0]
    for a, b in holes:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if iv[1] > t:
        out.append((t, iv[1]))
    return out


def _union_s(intervals):
    """Seconds covered by at least one of the intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class _Open:
    """One open span on this thread: its ids and its children's intervals."""

    __slots__ = ("id", "parent", "call", "children")

    def __init__(self, stack):
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        self.children = []


class _Span:
    __slots__ = ("name", "rng", "open", "t0")

    def __init__(self, name):
        self.name = name
        self.rng = self.open = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rng = _range(f"ilqr::{self.name}")
            self.rng.__enter__()
        if _listening:
            stack = _local.__dict__.setdefault("stack", [])
            self.open = _Open(stack)
            stack.append(self.open)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.open is not None:
            t1 = time.perf_counter()
            stack = _local.stack
            stack.pop()
            if stack:
                stack[-1].children.append((self.t0, t1))
            own = _subtract((self.t0, t1), self.open.children)
            rec = SpanRecord(self.name, self.t0, t1, self.open.id,
                             self.open.parent, self.open.call,
                             sum(b - a for a, b in own))
            with _lock:
                for listener in _listening:
                    listener._add(rec, own)
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager timing its block as one span of `name` for every
    listener, and a profiler range while the profiler is on."""
    if _listening or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function is one span of `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_read(value, read=bool):
    """read(value) on the host (bool by default) as one host sync: a `sync`
    span and one count of SYNCS."""
    global SYNCS
    with span("sync"):
        SYNCS += 1
        return read(value)


class _Listener:
    def __enter__(self):
        self._t0 = time.perf_counter()
        with _lock:
            _listening.append(self)
        return self

    def __exit__(self, *exc):
        with _lock:
            _listening.remove(self)
        self._t1 = time.perf_counter()
        return False


class SpanRecorder(_Listener):
    """Keeps every span closed inside its `with` block."""

    def __init__(self):
        self._records = []

    def _add(self, rec, own):
        self._records.append(rec)

    def spans(self):
        """The SpanRecords in the order they closed."""
        with _lock:
            return list(self._records)

    def report(self):
        """{name: {"count", "total_s" (summed durations), "self_s" (summed
        self times)}}."""
        out = {}
        for r in self.spans():
            e = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            e["count"] += 1
            e["total_s"] += r.end_s - r.start_s
            e["self_s"] += r.self_s
        return out


class CompileMeter(_Listener):
    """Collects the port's first-call spans (solver_build, nvcc, load)
    inside a `with` block."""

    def __init__(self):
        self._spans = []        # (name, t0, t1, own intervals)
        self._t0 = self._t1 = None

    def _add(self, rec, own):
        """Record a metered span, clipped to the block (called under the
        lock)."""
        if rec.name not in _NAMES:
            return
        lo = self._t0
        self._spans.append((rec.name, max(rec.start_s, lo), rec.end_s,
                            [(max(a, lo), b) for a, b in own if b > lo]))

    def report(self, wall_s=None):
        """{solver_build_s, nvcc_s, load_s, nvcc_sum_s (seconds), compiles,
        loads, solver_builds}; with `wall_s`, the caller's wall time around
        the whole `with` block, also `other_s`. A `wall_s` shorter than the
        block raises ValueError: it was not measured around it."""
        with _lock:
            spans = list(self._spans)
        out = {f"{name}_s": _union_s(iv for n, _, _, own in spans
                                     if n == name for iv in own)
               for name in _NAMES}
        out["nvcc_sum_s"] = sum((t1 - t0 for n, t0, t1, _ in spans
                                 if n == "nvcc"), 0.0)
        for name, key in _COUNTS.items():
            out[key] = sum(n == name for n, _, _, _ in spans)
        if wall_s is not None:
            block = (self._t1 or time.perf_counter()) - self._t0
            if wall_s < block:
                raise ValueError(f"wall_s {wall_s} is shorter than the "
                                 f"metered block ({block} s)")
            out["other_s"] = wall_s - _union_s((t0, t1)
                                               for _, t0, t1, _ in spans)
        return out
