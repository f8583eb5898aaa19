"""`BENCHMARK.json` and the files it names, found by name.

  configs[].file                 the configuration (JSON); its "problem"
                                 names `problems/<problem>.py`
  traffic/<traffic>.json         a mix, read by `traffic.py`
  limits/<cell>.json             the numbers the check compares, and their
                                 limits
  endtoend/<metric>.py           an end-to-end metric's reader
  metrics/<metric>.py            a per-layer metric's reader
A reader is a module with `read(ctx) -> float or None`. A metric named
`<quantity>.<part>` (one quantity split by the cells that report it) is
read by `<quantity>.<part>.py` where there is one, else by `<quantity>.py`.
"""

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_reader(path):
    """Import the file at `path` as a module of its own."""
    name = "benchmark_reader_" + "".join(c if c.isalnum() else "_" for c in
                                         str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, bench, entry):
        self.bench = bench
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.traffic = entry["traffic"]
        cfg_entry = bench.configs[entry["config"]]
        self.config = _json(ROOT / cfg_entry["file"])
        self.mix = _json(self.traffic_file)

    @property
    def traffic_file(self):
        return BENCH / "traffic" / f"{self.traffic}.json"

    @property
    def limits_file(self):
        return BENCH / "limits" / f"{self.name}.json"

    def limits(self):
        return _json(self.limits_file)

    def problem(self):
        return importlib.import_module(f"benchmark.problems.{self.config['problem']}")

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench.data["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose moved metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench.data["per_layer"]:
            listed = m.get("workloads")
            if self.name in listed if listed is not None else m["moves"] in mine:
                out.append(m)
        return out


class Benchmark:
    def __init__(self, data):
        self.data = data
        self.configs = {c["name"]: c for c in data["configs"]}
        self.cells = {w["name"]: w for w in data["workloads"]}

    @classmethod
    def load(cls, path=ROOT / "BENCHMARK.json"):
        return cls(_json(path))

    def cell(self, name):
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(self.cells)}")
        return Cell(self, self.cells[name])

    @staticmethod
    def reader(kind, name):
        """kind "endtoend" or "metrics"."""
        path = BENCH / kind / f"{name}.py"
        if not path.is_file():
            path = BENCH / kind / f"{name.split('.')[0]}.py"
        return load_reader(path)
