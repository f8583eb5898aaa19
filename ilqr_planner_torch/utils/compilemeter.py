"""First-call phase attribution: the port's own build costs vs everything else.

The port compiles no program at its first call the way XLA does; what a
first call pays for is building things once and caching them. Each such
cost is a span, opened at the site where the cost arises:

    solver_build  a solver memo miss in `parallel/mesh.py` (the fleet's
                  host constants), and a kernel wrapper's per-setting
                  device constants copied to the card on a cache miss;
    nvcc          one nvcc run (`ops/cuda_kernels/nvcc_build.build`), only
                  when the library is not already built;
    load          `ctypes.CDLL` of a built library and its argument types
                  (`nvcc_build.load`).

A `CompileMeter` listens to the spans opened inside its `with` block:

    with CompileMeter() as cm:
        first_call()
    cm.report(wall_s=...)

Nothing is counted twice. A span's time excludes the spans nested inside
it on the same thread (a kernel built inside a solver build counts once,
as nvcc). Each `<name>_s` is the wall time during which at least one span
of that name ran on its own time: the union of their intervals, so builds
running on several threads at once count their overlap once;
`nvcc_sum_s` is the sum of the nvcc runs' own times (above `nvcc_s` when
builds run in parallel). `other_s` is `wall_s` less the union of every
span's interval, so it is never negative. Spans of two names on two
threads may overlap: the names' times may then add to more than that
union.

CUDA's own first-call costs are in no span and fall to `other_s`: creating
the context, lazy-loading PyTorch's kernel modules, the caching
allocator's first blocks (a first copy to the card inside a solver build
pays for these there).

`span` is the hook the sites call. While no meter listens it costs one
check. Listeners are guarded by a lock: libraries are built from many
threads at once.
"""

import contextlib
import threading
import time

__all__ = ["CompileMeter", "span"]

_NAMES = ("solver_build", "nvcc", "load")
_COUNTS = {"solver_build": "solver_builds", "nvcc": "compiles",
           "load": "loads"}

_lock = threading.Lock()
_listening = []                 # meters inside their `with` block
_local = threading.local()      # this thread's open spans


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


@contextlib.contextmanager
def span(name: str):
    """Time the block as one span of `name` for every listening meter."""
    if not _listening:
        yield
        return
    stack = _local.__dict__.setdefault("stack", [])
    children = []
    stack.append(children)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        stack.pop()
        if stack:
            stack[-1].append((t0, t1))
        own = _subtract((t0, t1), children)
        with _lock:
            for meter in _listening:
                meter._add(name, t0, t1, own)


class CompileMeter:
    """Collects the port's first-call spans inside a `with` block."""

    def __init__(self):
        self._spans = []        # (name, t0, t1, own intervals)
        self._t0 = self._t1 = None

    def _add(self, name, t0, t1, own):
        """Record a span, clipped to the block (called under the lock)."""
        lo = self._t0
        self._spans.append((name, max(t0, lo), t1,
                            [(max(a, lo), b) for a, b in own if b > lo]))

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
