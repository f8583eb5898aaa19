"""The host cost of one span of `utils/compilemeter.py`, in microseconds.

    python3 tools/span_cost.py

Prints one JSON line: the microseconds an empty `with span(...)` block
costs, less an empty loop's, with nothing listening (`off`), with a
decorated function (`spanned_off`, less a plain call), with a
`SpanRecorder` listening (`recorder`), and under torch's profiler on the
host alone (`profiler`, each span one `ilqr::` host range); and one
`host_read` of a CPU tensor with nothing on (`host_read_off`, less a plain
`bool`). Each is the best of 5 repeats of N spans (200k; the recorder a
tenth of them, the profiler a hundredth). It needs no card.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from ilqr_planner_torch.utils import compilemeter  # noqa: E402
from ilqr_planner_torch.utils.compilemeter import (SpanRecorder, host_read,  # noqa: E402
                                                   span, spanned)


N = 200000


def _best_us(fn, n):
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def _spans(n):
    for _ in range(n):
        with span("x"):
            pass


def _loop(n):
    for _ in range(n):
        pass


def _plain():
    pass


_decorated = spanned("x")(_plain)


def _calls(fn):
    def run(n):
        for _ in range(n):
            fn()
    return run


def main():
    assert not compilemeter._listening
    assert not torch.autograd.profiler._is_profiler_enabled
    loop = _best_us(_loop, N)
    out = {"off": _best_us(_spans, N) - loop,
           "spanned_off": _best_us(_calls(_decorated), N) - _best_us(_calls(_plain), N)}
    flag = torch.tensor(True)
    out["host_read_off"] = (_best_us(_calls(lambda: host_read(flag)), N)
                            - _best_us(_calls(lambda: bool(flag)), N))
    with SpanRecorder():
        out["recorder"] = _best_us(_spans, N // 10) - loop
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["profiler"] = _best_us(_spans, N // 100) - loop
    print(json.dumps(out))


if __name__ == "__main__":
    main()
