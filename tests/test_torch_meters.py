"""Port parity, the first-call meters: `utils/calibprobe.py` and
`utils/compilemeter.py`, on the CPU.

The probe body against the JAX probe's (written out as in the JAX
package's `utils/calibprobe.py`, a scan of the same steps) on the same
[8, 65536] float32 input for 400 steps: its four values and its last sum
within rtol 1e-5 (float32, the ops in one order). The compile meters of
both packages around a first and a second batch solve of one tiny problem
(H=16, B=4, float64): one solver build, then none, against at least one
XLA compile, then none. This file compiles one JAX solve beside the probe's
float32 scan (tests/conftest.py). The nvcc accounting runs with a fake
nvcc that sleeps 50 ms: parallel builds count their overlap once, a build
nested in a solver build counts once, as nvcc; and more threads than cores
open spans at once under a one-microsecond switch interval, none lost.

The port's spans and host syncs: with no listener and no profiler a span
opens no profiler range; a recorded batch solve nests its spans under one
`dispatch` with one call id, and their self times add up to its duration;
a `dispatch` span around the metered block leaves `CompileMeter`'s report
as it was (a fake clock); `SYNCS` rises by exactly the guards that the
trials and iterations imply, plus the spec's copies to the host; under the
profiler each span is one `ilqr::` host range, nested as the spans are.
"""

import contextlib
import math
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_overrides import Q0, _keypoints, _specs

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import nvcc_build
from ilqr_planner_torch.parallel import mesh, solve_batch
from ilqr_planner_torch.solvers import fleet, ilqr
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec
from ilqr_planner_torch.utils import compilemeter
from ilqr_planner_torch.utils.calibprobe import (_SHAPE, _STEPS,
                                                 calibration_probe,
                                                 probe_program)
from ilqr_planner_torch.utils.compilemeter import CompileMeter, SpanRecorder, span

H, B, NB_ITER = 16, 4, 3
FAKE_NVCC_S = 0.05


# ---------------------------------------------------------------------------
# the calibration probe
# ---------------------------------------------------------------------------

def test_probe_body_matches_jax():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def probe(x):
        def step(c, _):
            c = c * 1.0000001 + 0.3 * jnp.sin(c) - 0.1 * c * c * 0.001
            return c, jnp.sum(c[:1, :8])
        c, out = jax.lax.scan(step, x, None, length=_STEPS)
        return c.ravel()[:4], out[-1]

    x = np.full(_SHAPE, 0.5, np.float32)
    ref = probe(jnp.asarray(x))
    got = probe_program(torch.as_tensor(x))
    assert got[0].dtype == torch.float32 and got[0].shape == (4,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)


def test_probe_on_the_cpu_and_without_a_card():
    calib_s = calibration_probe(repeats=1, device="cpu")
    assert math.isfinite(calib_s) and calib_s > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calibration_probe()


# ---------------------------------------------------------------------------
# the meters against each other
# ---------------------------------------------------------------------------

def _metered(meter, fn):
    """fn() inside the meter -> its report with the wall around it, and
    that wall as `wall_s`."""
    t0 = time.perf_counter()
    with meter:
        fn()
    wall = time.perf_counter() - t0
    return dict(meter.report(wall_s=wall), wall_s=wall)


def test_first_and_cached_solve_match_jax_meter(monkeypatch):
    from ilqr_planner_tpu.parallel import mesh as jmesh
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch
    from ilqr_planner_tpu.utils.compilemeter import CompileMeter as JMeter

    jspec, spec = _specs(H=H)
    rng = np.random.default_rng(0)
    x0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    U0s = np.zeros((B, H - 1, 7))
    # both solver memos start empty, whatever ran before in this process
    monkeypatch.setattr(mesh, "_fleet_cache", type(mesh._fleet_cache)())
    monkeypatch.setattr(jmesh, "_fleet_cache", type(jmesh._fleet_cache)())
    port = [_metered(CompileMeter(), lambda: solve_batch(
        spec, {"x0": x0s}, U0s, NB_ITER)) for _ in range(2)]
    assert [r["solver_builds"] for r in port] == [1, 0]
    assert port[0]["solver_build_s"] > 0 and port[1]["solver_build_s"] == 0
    for r in port:
        assert r["compiles"] == r["loads"] == 0 and r["other_s"] >= 0
    jax_counts = []
    for _ in range(2):
        with JMeter() as jm:
            np.asarray(jsolve_batch(jspec, {"x0": x0s}, U0s, NB_ITER).cost)
        jax_counts.append(jm.report()["compiles"])
    assert jax_counts[0] >= 1 and jax_counts[1] == 0


# ---------------------------------------------------------------------------
# nvcc accounting, with a fake nvcc
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """nvcc_build with its library directory in tmp_path and an nvcc that
    waits for `barrier` (when set) and then sleeps FAKE_NVCC_S and writes
    its -o file -> (a function writing the i-th source, the state)."""
    state = {"barrier": None, "runs": 0}

    def run(cmd, **kw):
        if state["barrier"] is not None:
            state["barrier"].wait(timeout=30)
        time.sleep(FAKE_NVCC_S)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        state["runs"] += 1
        return type("Proc", (), {"returncode": 0, "stderr": "ptxas info"})()

    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc_build.subprocess, "run", run)

    def source(i):
        path = tmp_path / f"kernel{i}.cu"
        path.write_text(f"// kernel {i}\n")
        return path

    return source, state


def test_parallel_builds_count_their_overlap_once(fake_nvcc):
    source, state = fake_nvcc
    sources = [source(i) for i in range(4)]
    state["barrier"] = threading.Barrier(4)
    with ThreadPoolExecutor(4) as ex:
        r = _metered(CompileMeter(),
                     lambda: list(ex.map(nvcc_build.build, sources)))
    state["barrier"] = None
    assert r["compiles"] == state["runs"] == 4
    assert r["nvcc_sum_s"] >= 4 * FAKE_NVCC_S
    # the four runs overlap for at least FAKE_NVCC_S: their union is shorter
    assert FAKE_NVCC_S <= r["nvcc_s"] < r["nvcc_sum_s"]
    assert r["nvcc_s"] <= r["wall_s"] and r["other_s"] >= 0
    again = _metered(CompileMeter(), lambda: nvcc_build.build(sources[0]))
    assert again["compiles"] == 0 and again["nvcc_s"] == 0
    assert state["runs"] == 4


def test_nested_build_counts_once_as_nvcc(fake_nvcc):
    source, _ = fake_nvcc

    def solver_build():
        with compilemeter.span("solver_build"):
            time.sleep(0.02)
            nvcc_build.build(source(0))

    t0 = time.perf_counter()
    with CompileMeter() as cm:
        solver_build()
    wall = time.perf_counter() - t0
    r = cm.report(wall_s=wall)
    assert r["solver_builds"] == r["compiles"] == 1
    assert r["nvcc_s"] >= FAKE_NVCC_S and r["solver_build_s"] >= 0.02
    # the build's own time and the nested nvcc run are disjoint
    assert r["solver_build_s"] + r["nvcc_s"] <= wall
    assert r["solver_build_s"] < r["nvcc_s"]
    assert r["other_s"] >= 0
    with pytest.raises(ValueError, match="shorter than the metered block"):
        cm.report(wall_s=wall / 2)


def test_loads_are_counted_once(fake_nvcc, monkeypatch):
    source, _ = fake_nvcc

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(nvcc_build, "_loaded", {})
    monkeypatch.setattr(nvcc_build.ctypes, "CDLL", lambda path: Lib())
    src = source(0)
    first = _metered(CompileMeter(), lambda: nvcc_build.load(src, {"f": []}))
    second = _metered(CompileMeter(), lambda: nvcc_build.load(src, {"f": []}))
    assert (first["compiles"], first["loads"]) == (1, 1)
    assert (second["compiles"], second["loads"]) == (0, 0)
    assert first["load_s"] > 0 and second["load_s"] == 0


def test_spans_outside_the_block_are_not_heard():
    """A span closed before a meter listens, or after it stopped, is in no
    report; a span on another thread is heard."""

    def load_span():
        with compilemeter.span("load"):
            time.sleep(0.001)

    with compilemeter.span("solver_build"):
        pass
    with CompileMeter() as cm:
        t = threading.Thread(target=load_span)
        t.start()
        t.join()
    with compilemeter.span("nvcc"):
        pass
    r = cm.report()
    assert (r["solver_builds"], r["loads"], r["compiles"]) == (0, 1, 0)
    assert r["load_s"] > 0 and "other_s" not in r


def test_spans_from_many_threads_are_all_heard():
    """More threads than cores open spans at once, with the interpreter
    switching threads every microsecond: no span is lost, and the union of
    one name's spans is never longer than the block."""
    import os
    import sys

    threads, per_thread = 4 * (os.cpu_count() or 1) + 1, 50
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=60)
        for _ in range(per_thread):
            with compilemeter.span("load"):
                pass

    def run_all():
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        r = _metered(CompileMeter(), run_all)
    finally:
        sys.setswitchinterval(old)
    assert r["loads"] == threads * per_thread
    assert r["load_s"] <= r["wall_s"] and r["other_s"] >= 0


# ---------------------------------------------------------------------------
# the port's spans and host syncs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """The flagship's kind at H=16 in float64 on the CPU, port only ->
    (spec, x0s [B, 7], U0s)."""
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    qmax = np.ones(7) * np.pi * 10
    spec = make_spec("posorn", robot, _keypoints("posorn", 1, H, kps_mod),
                     np.ones(7) * 1e-5, H, 1, device="cpu", dt=0.1, q0=Q0,
                     q_max=qmax, q_min=-qmax)
    rng = np.random.default_rng(3)
    x0s = torch.as_tensor(Q0[None] + 0.05 * rng.normal(size=(B, 7)))
    return spec, x0s, torch.zeros(B, H - 1, 7, dtype=torch.float64)


def test_span_off_opens_no_range(problem, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name} was opened")

    monkeypatch.setattr(compilemeter, "_range", no_range)
    assert not compilemeter._listening
    assert not torch.autograd.profiler._is_profiler_enabled
    spec, x0s, U0s = problem
    res = solve_batch(spec, {"x0": x0s}, U0s, NB_ITER)
    assert torch.isfinite(res.cost).all()
    with span("dispatch"), span("sync"):
        pass


def test_nested_spans_ids_and_self_times(monkeypatch):
    class Clock:
        now = 0.0

        def perf_counter(self):
            return self.now

    clock = Clock()
    monkeypatch.setattr(compilemeter, "time", clock)
    with SpanRecorder() as rec:
        for _ in range(2):
            with span("a"):
                clock.now += 1
                for _ in range(2):
                    with span("b"):
                        clock.now += 2
                clock.now += 3
    a1, a2 = [s for s in rec.spans() if s.name == "a"]
    bs = [s for s in rec.spans() if s.name == "b"]
    assert (a1.parent, a1.call, a1.end_s - a1.start_s, a1.self_s) == (None, a1.id, 8, 4)
    assert [(b.parent, b.call, b.self_s) for b in bs[:2]] == [(a1.id, a1.id, 2)] * 2
    assert [(b.parent, b.call) for b in bs[2:]] == [(a2.id, a2.id)] * 2
    assert a2.id != a1.id and a2.parent is None
    assert rec.report() == {"b": {"count": 4, "total_s": 8.0, "self_s": 8.0},
                            "a": {"count": 2, "total_s": 16.0, "self_s": 8.0}}


def test_solve_spans_nest_under_dispatch(problem):
    spec, x0s, U0s = problem
    solve_batch(spec, {"x0": x0s}, U0s, NB_ITER)
    with SpanRecorder() as rec:
        res = solve_batch(spec, {"x0": x0s}, U0s, NB_ITER)
    spans = rec.spans()
    (d,) = [s for s in spans if s.name == "dispatch"]
    by_id = {s.id: s for s in spans}
    assert d.parent is None and all(s.call == d.id for s in spans)
    parents = {}
    for s in spans:
        if s is not d:
            p = by_id[s.parent]
            assert p.start_s <= s.start_s <= s.end_s <= p.end_s
            parents.setdefault(s.name, set()).add(p.name)
    assert parents["fleet.iteration"] == {"dispatch"}
    assert parents["fleet.backward"] == parents["fleet.line_search"] == {"fleet.iteration"}
    assert parents["fleet.rollout"] == {"dispatch"}      # the initial rollout
    assert parents["sync"] == {"dispatch", "fleet.iteration", "fleet.line_search"}
    assert parents["stage_terms"] <= {"dispatch", "fleet.backward", "fleet.line_search",
                                      "fleet.rollout", "stage_terms"}
    report = rec.report()
    assert report["fleet.iteration"]["count"] == int(res.iterations.max()) + 1
    assert sum(s.self_s for s in spans) == pytest.approx(d.end_s - d.start_s, rel=0.01)


def test_compile_meter_report_unchanged_under_dispatch(monkeypatch):
    class Clock:
        now = 0.0

        def perf_counter(self):
            return self.now

    clock = Clock()
    monkeypatch.setattr(compilemeter, "time", clock)

    def metered(outer):
        clock.now = 0.0
        with CompileMeter() as cm:
            with outer:
                clock.now += 1
                with span("solver_build"):
                    clock.now += 2
                    with span("nvcc"):
                        clock.now += 3
                clock.now += 4
        return cm.report(wall_s=clock.now + 0.5)

    bare = metered(contextlib.nullcontext())
    assert metered(span("dispatch")) == bare
    assert (bare["solver_build_s"], bare["nvcc_s"], bare["other_s"]) == (2, 3, 5.5)
    assert (bare["solver_builds"], bare["compiles"], bare["loads"]) == (1, 1, 0)


@pytest.mark.parametrize("line_search", [True, False])
@pytest.mark.parametrize("route", ["fleet", "recursive"])
def test_syncs_are_the_guards_and_the_spec_copies(problem, route, line_search):
    """Each loop pass reads one guard (the last one ends the loop); each
    line search one before each trial and one that ends it, unless it ran
    the whole schedule; the fleet's dispatch copies each spec tensor to the
    host once to fingerprint it."""
    spec, x0s, U0s = problem
    fleet_route = route == "fleet"
    kw = dict(line_search=line_search, prefer_fleet=fleet_route, record=True)
    solve_batch(spec, {"x0": x0s}, U0s, NB_ITER, **kw)
    counter = fleet if fleet_route else ilqr
    s0, t0 = compilemeter.SYNCS, counter.TRIALS
    res = solve_batch(spec, {"x0": x0s}, U0s, NB_ITER, **kw)
    syncs, trials = compilemeter.SYNCS - s0, counter.TRIALS - t0
    iters = int(res.iterations.max())
    last_alpha = 2.0 ** -10 if line_search else 1.0
    ran_all = int((res.progress["alpha"] == last_alpha).any(0).sum())
    copies = len(spec.tensors()) if fleet_route else 0
    assert trials >= iters >= 1
    assert syncs == (iters + 1) + trials + (iters - ran_all) + copies


def test_profiler_ranges_nest_as_the_spans(problem):
    spec, x0s, U0s = problem
    solve_batch(spec, {"x0": x0s}, U0s, NB_ITER)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with SpanRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        solve_batch(spec, {"x0": x0s}, U0s, NB_ITER)
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = rec.spans()
    by_id = {s.id: s for s in spans}
    want = Counter((s.name, by_id[s.parent].name if s.parent else None)
                   for s in spans)

    def outer_range(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("ilqr::"):
            p = p.cpu_parent
        return p.name.removeprefix("ilqr::") if p is not None else None

    ranges = [e for e in prof.events() if e.name.startswith("ilqr::")]
    got = Counter((e.name.removeprefix("ilqr::"), outer_range(e)) for e in ranges)
    assert got == want
    assert {e.device_type for e in ranges} == {torch.autograd.DeviceType.CPU}
    assert not any(getattr(e, "is_user_annotation", False) for e in ranges)
