"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository root (CPU); those marked `cuda` run only where a card is."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402

# The replan mix (traffic/replan_b256_i2.json, limits/posorn_h100.replan.json)
# is out of BENCHMARK.json until its tail is steady (PERF.md §7); it stays
# these tests' small case.
REPLAN = {"name": "posorn_h100.replan", "config": "posorn_h100",
          "traffic": "replan_b256_i2", "chips": 1}


@pytest.fixture
def cell_of():
    """name -> that cell of BENCHMARK.json, or the replan mix's cell."""
    from benchmark.cells import Benchmark, Cell

    def get(name):
        bench = Benchmark.load()
        return Cell(bench, REPLAN) if name == REPLAN["name"] else bench.cell(name)
    return get
