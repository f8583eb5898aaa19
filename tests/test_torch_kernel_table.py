"""The port's kernel table, its imports and its launch geometry, on the CPU.

(a) Every public function of the JAX package that reaches `pl.pallas_call`
    (found by reading the sources under `ilqr_planner_tpu/ops/pallas_kernels/`
    as text) is named in the header of one `ilqr_planner_torch/csrc/*.cu`
    and has a row in PERF.md's kernel table.
(b) No module of the port, nor `chip_smoke.py`, imports JAX or the JAX
    package (an `ast` walk, so comments and strings do not count).
(c) The launch-geometry helpers of the kernels that run several threads a
    lane (riccati at each built width) cover every lane of a batch and stay
    within the shared memory a block may take on the H100, and their
    constants and widths are the ones the CUDA sources define.
"""

import ast
import pathlib
import re

import pytest
import torch

from ilqr_planner_torch.ops.cuda_kernels import (nvcc_build, riccati,
                                                 rollout_time1,
                                                 segment_backward_2nd)

REPO = pathlib.Path(__file__).resolve().parents[1]
PALLAS = REPO / "ilqr_planner_tpu" / "ops" / "pallas_kernels"
CSRC = REPO / "ilqr_planner_torch" / "csrc"


def _names_used(fn):
    """Names a function's body mentions; 'pallas_call' where it calls
    `<anything>.pallas_call`."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "pallas_call"):
            names.add("pallas_call")
    return names


def _pallas_entry_points():
    """(file name, function) of every public module-level function that
    reaches `pallas_call`, directly or through functions of its module."""
    found = []
    for path in sorted(PALLAS.glob("*.py")):
        tree = ast.parse(path.read_text())
        funcs = {n.name: _names_used(n) for n in tree.body
                 if isinstance(n, ast.FunctionDef)}
        reach = {name for name, used in funcs.items() if "pallas_call" in used}
        while True:
            more = {name for name, used in funcs.items()
                    if name not in reach and used & reach}
            if not more:
                break
            reach |= more
        found += [(path.name, name) for name in sorted(reach)
                  if not name.startswith("_")]
    return found


ENTRY_POINTS = _pallas_entry_points()


def _cu_headers():
    """The leading comment block of every CUDA source."""
    headers = {}
    for path in sorted(CSRC.glob("*.cu")):
        lines = []
        for line in path.read_text().splitlines():
            if not line.startswith("//"):
                break
            lines.append(line)
        headers[path.name] = "\n".join(lines)
    return headers


def _perf_table_rows():
    """The rows of PERF.md's table of TPU kernels."""
    return [line for line in (REPO / "PERF.md").read_text().splitlines()
            if line.startswith("| `") and "pallas_kernels/" in line]


def test_entry_points_found():
    """The text search finds the JAX package's kernels: at least the five the
    port has sources for, in four files."""
    assert len(ENTRY_POINTS) >= 5
    assert {f for f, _ in ENTRY_POINTS} >= {
        "riccati.py", "rollout_time1.py", "segment_backward.py",
        "segment_backward_2nd.py"}


@pytest.mark.parametrize("file,func", ENTRY_POINTS)
def test_kernel_named_in_a_cuda_header(file, func):
    """The function, with its file, stands in the header of a CUDA source."""
    pattern = re.compile(rf"\b{re.escape(func)}\b")
    hits = [name for name, header in _cu_headers().items()
            if pattern.search(header) and f"pallas_kernels/{file}" in header]
    assert len(hits) == 1, (func, hits)


@pytest.mark.parametrize("file,func", ENTRY_POINTS)
def test_kernel_has_a_row_in_perf_table(file, func):
    """One row of PERF.md's table names the function, its file, and the
    CUDA source that ports it."""
    pattern = re.compile(rf"`{re.escape(func)}`")
    rows = [r for r in _perf_table_rows()
            if pattern.search(r) and f"pallas_kernels/{file}" in r]
    assert len(rows) == 1, (func, rows)
    assert re.search(r"ilqr_planner_torch/csrc/\w+\.cu", rows[0])
    assert (REPO / re.search(r"ilqr_planner_torch/csrc/\w+\.cu",
                             rows[0]).group(0)).exists()


PORT_SOURCES = sorted(str(p.relative_to(REPO))
                      for p in (REPO / "ilqr_planner_torch").rglob("*.py")
                      ) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_imports_no_jax(rel):
    """No `import jax`, `from jax ...` or import of `ilqr_planner_tpu`."""
    banned = []
    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        banned += [m for m in mods
                   if m.split(".")[0] in ("jax", "jaxlib", "ilqr_planner_tpu")]
    assert not banned, (rel, banned)


BATCHES = (1, 31, 45, 2048, 4096, 4133)
GEOMETRIES = {
    "second": lambda B, dt: segment_backward_2nd.launch_geometry("second", B, dt),
    "time1": lambda B, dt: segment_backward_2nd.launch_geometry("time1", B, dt),
    "rollout_time1": rollout_time1.launch_geometry,
    **{f"riccati_{n}x{nq}": (lambda B, dt, nq=nq: riccati.launch_geometry(B, dt, nq))
       for n, nq in riccati.KERNEL_WIDTHS},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kernel", sorted(GEOMETRIES))
def test_launch_geometry(kernel, B, dtype):
    """Blocks x lanes a block cover the batch with less than one block to
    spare; the block fits the threads and the shared memory one H100 SM
    gives a block; at least one block is resident an SM."""
    g = GEOMETRIES[kernel](B, dtype)
    assert g["blocks"] * g["lanes_per_block"] >= B
    assert (g["blocks"] - 1) * g["lanes_per_block"] < B
    assert g["threads"] % 32 == 0 and 32 <= g["threads"] <= 1024
    assert g["threads"] % g["lanes_per_block"] == 0
    assert 0 < g["smem_bytes"] <= 227 * 1024
    assert g["smem_bytes"] <= nvcc_build.SMEM_PER_BLOCK_MAX
    assert g["lanes_per_sm"] >= g["lanes_per_block"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert g["smem_bytes"] % (g["lanes_per_block"] * itemsize) == 0


def test_geometry_matches_the_cuda_sources():
    """The wrappers' launch constants and built widths are the ones the CUDA
    sources define."""
    sweep = (CSRC / "segment_backward_2nd.cu").read_text()
    sb2 = segment_backward_2nd
    assert re.search(r"constexpr int kLanes = (\d+);", sweep).group(1) == str(
        sb2.LANES_PER_BLOCK["second"])
    assert re.search(r"constexpr int kGroup = (\d+);", sweep).group(1) == str(
        sb2.THREADS_PER_LANE["second"])
    assert re.search(r"#define SECOND_AHEAD (\d+)", sweep).group(1) == str(
        sb2.STEPS_AHEAD["second"])
    assert re.search(r"#define TIME1_LANES (\d+)", sweep).group(1) == str(
        sb2.LANES_PER_BLOCK["time1"])
    assert re.search(r"#define TIME1_AHEAD (\d+)", sweep).group(1) == str(
        sb2.STEPS_AHEAD["time1"])
    # 'time1': a thread a column of [Qux | Qu], n + 1
    assert re.search(r"kGroup = N_ \+ 1", sweep)
    assert sb2.THREADS_PER_LANE["time1"] == sb2.KERNEL_WIDTHS["time1"][0] + 1
    ric = (CSRC / "riccati.cu").read_text()
    assert re.search(r"#define RICCATI_LANES (\d+)", ric).group(1) == str(
        riccati.LANES_PER_BLOCK)
    assert re.search(r"#define RICCATI_STEPS (\d+)", ric).group(1) == str(
        riccati.STEPS_PER_CHUNK)
    assert re.search(r"kThreads = \(N \+ 1\) \* kLanes", ric)
    assert all(riccati.THREADS_PER_LANE == n + 1 for n, _ in riccati.KERNEL_WIDTHS)
    built = re.findall(r"RICCATI_ENTRY\((\d+), (\d+), (float|double), f(?:32|64)\)", ric)
    assert sorted(built) == sorted((str(n), str(nq), t) for n, nq in riccati.KERNEL_WIDTHS
                                   for t in ("float", "double"))
    geometry = set(re.findall(r"if \(n == (\d+) && nq == (\d+)\)", ric))
    assert geometry == {(str(n), str(nq)) for n, nq in riccati.KERNEL_WIDTHS}
    roll = (CSRC / "rollout_time1.cu").read_text()
    assert re.search(r"#define ROLLOUT_LANES (\d+)", roll).group(1) == str(
        rollout_time1.LANES_PER_BLOCK)
    assert re.search(r"#define ROLLOUT_STAGES (\d+)", roll).group(1) == str(
        rollout_time1.RING_STAGES)
