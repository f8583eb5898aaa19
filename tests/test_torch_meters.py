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
"""

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_overrides import Q0, _specs

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build
from ilqr_planner_torch.parallel import mesh, solve_batch
from ilqr_planner_torch.utils import compilemeter
from ilqr_planner_torch.utils.calibprobe import (_SHAPE, _STEPS,
                                                 calibration_probe,
                                                 probe_program)
from ilqr_planner_torch.utils.compilemeter import CompileMeter

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
