"""Nothing the harness runs loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level module names (the port's name starts with the
JAX package's)."""

import subprocess
import sys

from benchmark.cells import ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from benchmark import run, calibrate, faults
from benchmark.cells import BENCH, Benchmark, Cell
b = Benchmark.load()
for kind in ("metrics", "endtoend"):
    for f in sorted((BENCH / kind).glob("*.py")):
        Benchmark.reader(kind, f.stem)
cell = Cell(b, {{"name": "posorn_h100.replan", "config": "posorn_h100",
             "traffic": "replan_b256_i2", "chips": 1}})
cell.mix = dict(cell.mix, batch=4, pool=1, sample_lanes_per_call=2, check_lanes=4,
                warmup_calls=1)
res, _ = run.run_cell(cell, 5, 0.0, 0, device="cpu")
import ilqr_planner_torch
top = sorted({{m.split(".")[0] for m in sys.modules}})
print("TOP", " ".join(top))
print("BANNED", run.banned_modules())
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout.split("TOP ")[1].split("\n")[0].split()
    assert "ilqr_planner_torch" in top
    for banned in ("jax", "jaxlib", "flax", "ilqr_planner_tpu"):
        assert banned not in top
    assert "BANNED []" in out.stdout


def test_banned_names_are_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "ilqr_planner_tpu_like", sys)
    assert "ilqr_planner_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]
