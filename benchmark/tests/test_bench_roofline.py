"""The frozen counts give the bounds that the port's kernels were designed
against (PERF.md's table of kernels, at its batches), and the bounds at the
cells' own batches follow from them."""

import pytest

from benchmark import roofline
from benchmark.cells import Benchmark
from benchmark.profiling import Trace


def _ctx(cell):
    c = Benchmark.load().cell(cell)
    return {"config": c.config, "mix": c.mix, "dims": c.problem().dims(c.config)}


@pytest.mark.parametrize("cell, metric, table_batch, want_ms", [
    ("posorn_h100.bulk", "segment_backward_roofline_pct", 36864, 0.3383),
    ("timeopt_h100.bulk", "rollout_time1_roofline_pct", 2048, 0.0255)])
def test_bounds_at_the_cells_shapes(cell, metric, table_batch, want_ms):
    reader = Benchmark.reader("metrics", metric)
    ctx = _ctx(cell)
    at_table = dict(ctx, mix=dict(ctx["mix"], batch=table_batch))
    ms, by = reader.bound(at_table)["bound_ms"]
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, abs=5e-5)
    own_ms, by = reader.bound(ctx)["bound_ms"]
    assert by == "bytes"
    assert own_ms == pytest.approx(ms * ctx["mix"]["batch"] / table_batch, rel=1e-4)


def test_reader_finds_nothing_without_a_trace():
    ctx = _ctx("posorn_h100.bulk")
    for name in ("segment_backward_roofline_pct", "kernel_launches_per_solve",
                 "device_idle_pct.bulk", "line_search_trials_per_solve"):
        assert Benchmark.reader("metrics", name).read(ctx) is None


def test_readers_on_a_trace():
    ctx = _ctx("posorn_h100.bulk")
    ms = 0.5e-3
    ev = [("void segment_backward_kernel<float, 7>(...)", i, i + ms) for i in range(10)]
    ev += [("Memcpy DtoH (Device -> Pinned)", 20.0, 20.5)]
    ctx["trace"] = Trace(ev, [], 1.0, 0.0)
    ctx["walls"] = [1.0, 2.0, 10.0]
    pct = Benchmark.reader("metrics", "segment_backward_roofline_pct").read(ctx)
    B = ctx["mix"]["batch"]
    bound_ms, _ = roofline.bound_ms(roofline.sweep_bytes(7, 99, 1, B, 4),
                                    roofline.sweep_flops(7, 99, 1, B))
    assert pct == pytest.approx(100 * bound_ms / 0.5)
    assert Benchmark.reader("metrics", "kernel_launches_per_solve").read(ctx) == 10
    idle = Benchmark.reader("metrics", "device_idle_pct.bulk").read(ctx)
    assert idle == pytest.approx(100 * (1 - (10 * ms + 0.5) / 2.0))
    assert Benchmark.reader("metrics", "rollout_time1_roofline_pct").read(ctx) is None


def test_trace_reduction():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("Memcpy DtoH", 3.0, 3.5), ("k1", 6.0, 7.0)]
    host = [("aten::mul", 2.5, 3.1), ("aten::sum", 4.0, 6.2)]
    t = Trace(dev, host, 8.0, 0.0)
    assert t.busy == [[0.0, 2.0], [3.0, 3.5], [6.0, 7.0]] and t.busy_s == 3.5
    assert len(t.kernels()) == 3 and t.mean_ms("k1") == 1000.0
    assert t.device_ops()[0] == ["k1", 2.0]
    # the gap 2.0-3.0 ends while aten::mul runs, 3.5-6.0 while aten::sum runs
    assert t.idle_gaps() == [["aten::sum", 2.5], ["aten::mul", 1.0]]
    assert Trace(dev, [], 8.0, 0.0).idle_gaps() == [["python between operations", 3.5]]
