"""BENCHMARK.json keeps to its contract, and every name in it resolves to
its files."""

import json
import re

import pytest

from benchmark.cells import BENCH, ROOT, Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DATA["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51
    assert 2 + 14 * 24 * (DATA["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert DATA["paths"] == ["benchmark"]


def test_names_units_and_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in DATA[group]]
        assert len(set(names)) == len(names)
        for e in DATA[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in DATA["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in DATA["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in DATA["end_to_end"]}
    e2e = {m["name"] for m in DATA["end_to_end"]}
    for m in DATA["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = Benchmark.load().cell(cell)
    assert c.traffic_file.is_file() and c.limits_file.is_file()
    assert (BENCH / "problems" / f"{c.config['problem']}.py").is_file()
    c.problem()
    limits = c.limits()
    assert limits["compare"], "a cell compares at least one number"
    for name, lim in limits["compare"].items():
        assert lim["lower"] < lim["limit"] < lim["upper"], name
    reported = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    layer = c.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in reported
        assert hasattr(Benchmark.reader("metrics", m["name"]), "read")
    for name in reported:
        assert hasattr(Benchmark.reader("endtoend", name), "read")


def test_every_config_is_used_and_stands_alone():
    used = {w["config"] for w in DATA["workloads"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)
    for c in DATA["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
        assert (BENCH / cfg["urdf"]).is_file()
