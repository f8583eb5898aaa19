"""One short run of each cell's command on the card (skips without one)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.cells import ROOT, Benchmark

pytestmark = pytest.mark.cuda
CELLS = sorted(Benchmark.load().cells)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace",
                          str(trace)], capture_output=True, text=True, timeout=340,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert list(last)[-1] == "check"
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
    c = Benchmark.load().cell(cell)
    want = c.per_layer() if trace else c.end_to_end()
    assert {m["name"] for m in want} <= set(last["metrics"])
    assert all(v["value"] > 0 for v in last["metrics"].values())
