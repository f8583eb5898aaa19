"""The program's ranges in a profiled call are set aside (`spans.py`):
a synthetic event list that carries `ilqr::` host ranges and their device
copies reduces to the same device events, kernels and busy time as
`profiling.trace_call` gives for the list without them; `idle_by_span`
books the gap after a device-to-host copy to `sync`, and each other gap
to the innermost span open when it began; `sync_idle_pct` is the sync's
idle over the profiled call's wall; the five readers
of the spans read numbers on a CPU run of the small replan case
(sync_idle_pct None: a CPU has no device events), and None without a
trace or without the program's spans."""

import contextlib
import types

import pytest
import torch

from benchmark import profiling, spans
from benchmark.cells import Benchmark

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
READERS = ("host_syncs_per_solve", "dispatch_host_ms_per_solve",
           "fleet_loop_host_ms_per_solve", "stage_terms_host_ms_per_solve",
           "sync_idle_pct")


def _events(ranges):
    """(name, on the device, start_us, end_us) of a call of two host ops
    and a host sync, each launching device work; with `ranges`, the ranges
    ilqr::dispatch > ilqr::fleet.iteration, ilqr::sync around them, and
    the ranges' device copies."""
    out = [("aten::mul", False, 8, 20), ("aten::add", False, 9, 12),
           ("aten::sum", False, 30, 40), ("aten::is_nonzero", False, 62, 88),
           ("mul_kernel", True, 10, 22), ("sum_kernel", True, 35, 50),
           ("Memcpy DtoH", True, 70, 71), ("next_kernel", True, 92, 95)]
    if ranges:
        out = [("ilqr::dispatch", False, 0, 100), ("ilqr::fleet.iteration", False, 5, 60),
               ("ilqr::dispatch", True, 10, 95),
               ("ilqr::fleet.iteration", True, 10, 50)] + out + [
                   ("ilqr::sync", False, 60, 90)]
    return out


def _seconds(events):
    return [(n, d, a * 1e-6, b * 1e-6) for n, d, a, b in events]


def _parent_trace(events, monkeypatch):
    """`profiling.trace_call`'s own reduction of `events` as the profiler's
    event objects (aten::add nested in aten::mul)."""
    objs = {}
    for name, on_device, a, b in events:
        objs[name] = types.SimpleNamespace(
            name=name, device_type=CUDA if on_device else CPU,
            cpu_parent=objs.get("aten::mul") if name == "aten::add" else None,
            time_range=types.SimpleNamespace(start=a, end=b))
    prof = types.SimpleNamespace(events=lambda: list(objs.values()))
    monkeypatch.setattr(profiling.torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext(prof))
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda device: None)
    return profiling.trace_call(lambda: None, "cuda")


def test_ranges_are_set_aside(monkeypatch):
    got = spans.reduce_events(_seconds(_events(True)), 1.0, 0.0)
    want = _parent_trace(_events(False), monkeypatch)
    assert got.device_events == want.device_events
    assert got.kernels() == want.kernels() and len(got.kernels()) == 3
    assert got.busy_s == pytest.approx(want.busy_s) == pytest.approx(31e-6)
    assert got.device_ops() == want.device_ops()
    assert got.host_ops == []
    assert got.spans == [(n, a, b) for n, _, a, b in _seconds([
        ("dispatch", 0, 0, 100), ("fleet.iteration", 0, 5, 60), ("sync", 0, 60, 90)])]
    plain = spans.reduce_events(_seconds(_events(False)), 1.0, 0.0)
    assert plain.spans == [] and plain.device_events == got.device_events
    assert got.copies() == plain.copies() and [e[0] for e in got.copies()] == ["Memcpy DtoH"]


def test_idle_by_span_books_each_gap_to_the_innermost_span():
    us = 1e-6
    dev = [("k", 10 * us, 22 * us), ("k", 35 * us, 50 * us), ("k", 70 * us, 71 * us),
           ("k", 92 * us, 95 * us), ("k", 120 * us, 121 * us)]
    tr = spans.SpanTrace(dev, 1.0, 0.0,
                         [("sync", 60 * us, 90 * us), ("dispatch", 0.0, 100 * us),
                          ("fleet.iteration", 5 * us, 60 * us),
                          ("stage_terms", 20 * us, 30 * us)])
    got = {k: v / us for k, v in tr.idle_by_span()}
    # the gaps begin at 22 (stage_terms), 50 (fleet.iteration), 71 (sync)
    # and 95 (dispatch)
    assert got == pytest.approx({"stage_terms": 13, "fleet.iteration": 20, "sync": 21,
                                 "dispatch": 25})
    assert sum(v for _, v in tr.idle_by_span()) == pytest.approx(
        sum(v for _, v in tr.idle_gaps()))
    tr = spans.SpanTrace(dev[:2], 1.0, 0.0, [("sync", 30 * us, 40 * us)])
    assert tr.idle_by_span() == [[spans.OUTSIDE, pytest.approx(13 * us)]]


def test_sync_idle_pct_is_the_sync_share_of_the_profiled_wall():
    us = 1e-6
    # a gap of 2 us begins inside the sync range, one of 6 after the read's
    # copy, which ends past the range (the clocks differ), one of 10 in the
    # stage terms and one of 19 outside any span
    copy = "Memcpy DtoH (Device -> Pageable)"
    dev = [("k", 0.0, 10 * us), (copy, 12 * us, 14 * us), ("k", 20 * us, 30 * us),
           ("k", 40 * us, 41 * us), ("k", 60 * us, 70 * us)]
    tr = spans.SpanTrace(dev, 100 * us, 0.0, [("sync", 5 * us, 13 * us),
                                               ("stage_terms", 13 * us, 35 * us)])
    assert len(tr.copies()) == 1
    assert {k: v / us for k, v in tr.idle_by_span()} == pytest.approx(
        {"sync": 2 + 6, "stage_terms": 10, spans.OUTSIDE: 19})
    ctx = {"trace": profiling.Trace([], [], 1.0, 0.0), "spans": {"trace": tr}}
    assert Benchmark.reader("metrics", "sync_idle_pct").read(ctx) == pytest.approx(8.0)
    ctx["spans"]["trace"] = spans.SpanTrace(dev[:1], 1.0, 0.0, [])
    assert Benchmark.reader("metrics", "sync_idle_pct").read(ctx) == 0.0


@pytest.fixture
def small_ctx(cell_of):
    c = cell_of("posorn_h100.replan")
    mix = dict(c.mix, batch=4, pool=1, nb_iter=2)
    return {"config": c.config, "mix": mix, "walls": [0.5, 0.6],
            "trace": profiling.Trace([], [], 0.5, 0.0)}


def _read(ctx):
    return {name: Benchmark.reader("metrics", name).read(ctx) for name in READERS}


def test_readers_on_a_cpu_run(small_ctx, capsys):
    got = _read(small_ctx)
    assert got["sync_idle_pct"] is None
    for name in READERS[:4]:
        assert got[name] > 0, name
    m = small_ctx["spans"]
    assert m["report"]["dispatch"]["count"] == 1
    assert m["report"]["dispatch"]["total_s"] >= 0.9 * m["wall_s"]
    assert '"line": "spans"' in capsys.readouterr().out
    assert _read(small_ctx) == got                      # measured once a run


def test_readers_without_a_trace_or_the_spans(small_ctx, monkeypatch):
    from ilqr_planner_torch.utils import compilemeter

    no_trace = {k: v for k, v in small_ctx.items() if k != "trace"}
    assert set(_read(no_trace).values()) == {None} and "spans" not in no_trace
    monkeypatch.delattr(compilemeter, "SpanRecorder")
    monkeypatch.setattr(spans.traffic, "Inputs", None)    # nothing may run
    assert set(_read(small_ctx).values()) == {None}
