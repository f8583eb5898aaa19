"""The port's kernel table, its imports and its launch geometry, on the CPU.

(a) Every public function of the JAX package that reaches `pl.pallas_call`
    (found by reading the sources under `ilqr_planner_tpu/ops/pallas_kernels/`
    as text) is named in the header of one `ilqr_planner_torch/csrc/*.cu`
    and has a row in PERF.md's kernel table.
(b) No module of the port, nor `chip_smoke.py`, imports JAX or the JAX
    package, and no module under `ops/` imports the solvers (an `ast`
    walk, so comments and strings do not count).
(c) The launch-geometry helpers of the kernels (each at the 7-DoF arm's
    widths and at 6 and 3 DoF; riccati at each residual width, at the
    sequential specs' 12 and 13, the planar 2 and its widest; the limit
    penalty's two forms at the arm's state widths, first and second order
    and time-optimal; the affine family, first order and the double
    integrator, at 7, 6 and 3 DoF) cover every lane of a batch and stay within the
    shared memory a block may take on the H100; every width up to a
    wrapper's stated limit fits a block; and the wrappers' constants are
    the ones the CUDA sources define.
"""

import ast
import pathlib
import re

import pytest
import torch

from ilqr_planner_torch.ops.cuda_kernels import (affine_family,
                                                 limit_penalty, nvcc_build,
                                                 riccati, rollout_time1,
                                                 segment_backward,
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


def _imports(rel):
    """The modules a source imports: each `import a.b` as "a.b", each
    `from a import b, c` as "a.b" and "a.c"; a relative import resolved
    against the source's package."""
    pkg = pathlib.PurePosixPath(rel).parent.parts
    mods = []
    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(pkg[:len(pkg) - node.level + 1] if node.level else ())
            base = ".".join(filter(None, (base, node.module)))
            mods += [f"{base}.{a.name}" for a in node.names]
    return mods


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_imports_no_jax(rel):
    """No `import jax`, `from jax ...` or import of `ilqr_planner_tpu`."""
    banned = [m for m in _imports(rel)
              if m.split(".")[0] in ("jax", "jaxlib", "ilqr_planner_tpu")]
    assert not banned, (rel, banned)


def test_ops_import_no_solver():
    """The layers point one way: no module under `ilqr_planner_torch/ops/`
    imports from `ilqr_planner_torch.solvers` (the fleet hands the kernels
    plain tables)."""
    banned = [(rel, m) for rel in PORT_SOURCES
              if rel.startswith("ilqr_planner_torch/ops/")
              for m in _imports(rel)
              if m.startswith("ilqr_planner_torch.solvers")]
    assert not banned, banned


BATCHES = (1, 31, 45, 2048, 4096, 4133, 36864)
DOFS = (7, 6, 3)
GEOMETRIES = {
    **{f"segment_backward_n{d}": (lambda B, dt, d=d: segment_backward.launch_geometry(
        B, dt, d)) for d in DOFS},
    **{f"{kind}_dof{d}": (lambda B, dt, kind=kind, d=d:
                          segment_backward_2nd.launch_geometry(kind, B, dt, d))
       for kind in ("second", "time1") for d in DOFS},
    **{f"rollout_time1_n{d + 1}": (lambda B, dt, d=d: rollout_time1.launch_geometry(
        B, dt, d + 1)) for d in DOFS},
    **{f"riccati_{d}x{nq}": (lambda B, dt, d=d, nq=nq: riccati.launch_geometry(
        B, dt, d, nq)) for d in DOFS for nq in sorted(set(riccati.residual_widths(d)))},
    # the sequential specs' widths (two position + orientation subsystems;
    # joint + position/orientation), the planar point's, the widest
    **{f"riccati_{d}x{nq}": (lambda B, dt, d=d, nq=nq: riccati.launch_geometry(
        B, dt, d, nq)) for d, nq in ((7, 12), (7, 13), (3, 2))},
    "riccati_max_n_x_max_nq": lambda B, dt: riccati.launch_geometry(
        B, dt, riccati.MAX_N[dt], riccati.MAX_NQ[dt]),
    # the affine family: first order (n = m) and the double integrator
    # (n = 2m) at each DoF
    **{f"affine_family_n{d}_m{d}": (lambda B, dt, d=d: affine_family.launch_geometry(
        B, dt, d, d)) for d in DOFS},
    **{f"affine_family_n{2 * d}_m{d}": (lambda B, dt, d=d: affine_family.launch_geometry(
        B, dt, 2 * d, d)) for d in DOFS},
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", BATCHES + (131072, 294912))
@pytest.mark.parametrize("form", ["cost", "arrays"])
@pytest.mark.parametrize("H,n", [(100, 7), (100, 8), (400, 14), (1, 3)])
def test_limit_penalty_launch_geometry(H, n, form, B, dtype):
    """The limit penalty's blocks cover every lane of the batch (16 bytes of
    lanes a thread where B allows it) and every row, with less than one
    block of lanes to spare; a block fits one H100 SM; a cost launch splits
    the rows over at most 32 rows of threads a block, only while the
    launch stays within `COST_TARGET_THREADS` threads (one wave of the
    H100), in blocks of at least 128 threads, and its shared memory holds
    one partial sum a lane and row of threads; an arrays launch stays
    within the grid's 65535 row blocks."""
    lp = limit_penalty
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = lp.launch_geometry(form, B, dtype, H, n)
    assert g["vec"] == (16 // itemsize if B % (16 // itemsize) == 0 else 1)
    assert g["lanes_per_block"] % g["vec"] == 0
    gx, gy = g["grid"]
    assert g["blocks"] == gx * gy
    assert gx * g["lanes_per_block"] >= B > (gx - 1) * g["lanes_per_block"]
    assert gy * g["rows_per_block"] >= H * n > (gy - 1) * g["rows_per_block"]
    assert gy <= 65535
    assert g["threads"] % 32 == 0 and 32 <= g["threads"] <= 1024
    assert g["smem_bytes"] <= nvcc_build.SMEM_PER_BLOCK_MAX
    assert g["lanes_per_sm"] >= g["lanes_per_block"]
    lx, ty = g["block"]
    assert lx % 32 == 0 and g["threads"] == lx * ty
    assert g["lanes_per_block"] == lx * g["vec"]
    if form == "cost":
        assert ty & (ty - 1) == 0 and ty <= min(32, H * n)
        assert g["threads"] >= lp.COST_MIN_THREADS
        nv = -(-B // g["vec"])
        assert ty == 1 or nv * ty <= lp.COST_TARGET_THREADS
        assert (ty == 32 or 2 * ty > H * n
                or nv * 2 * ty > lp.COST_TARGET_THREADS)
        assert g["smem_bytes"] == g["threads"] * g["vec"] * itemsize
    else:
        assert g["threads"] == lp.ARRAYS_THREADS and g["smem_bytes"] == 0
        assert g["rows_per_block"] >= lp.ARRAYS_ROWS


# each wrapper's stated limit: (width in the wrapper's terms, its geometry)
LIMITS = {
    "segment_backward": (segment_backward.MAX_N, 1,
                         lambda w, dt: segment_backward.launch_geometry(64, dt, w)),
    "second": (segment_backward_2nd.MAX_DOF["second"], 1,
               lambda w, dt: segment_backward_2nd.launch_geometry("second", 64, dt, w)),
    "time1": (segment_backward_2nd.MAX_DOF["time1"], 1,
              lambda w, dt: segment_backward_2nd.launch_geometry("time1", 64, dt, w)),
    "rollout_time1": (rollout_time1.MAX_N, 2,
                      lambda w, dt: rollout_time1.launch_geometry(64, dt, w)),
    **{f"riccati_nq{label}": (riccati.MAX_N, 1, lambda w, dt, i=i: riccati.launch_geometry(
        64, dt, w, riccati.residual_widths(w)[i]))
       for i, label in enumerate(("6", "n", "3"))},
    **{f"affine_family{tag}": (
        {dt: affine_family.MAX_M[(second, dt)] for dt in (torch.float32, torch.float64)},
        1, lambda w, dt, second=second: affine_family.launch_geometry(
            64, dt, 2 * w if second else w, w))
       for second, tag in ((False, ""), (True, "_2nd"))},
    # the residual width nq, at each type's widest chain
    "riccati_residual": (riccati.MAX_NQ, 1, lambda w, dt: riccati.launch_geometry(
        64, dt, riccati.MAX_N[dt], w)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", sorted(LIMITS))
def test_every_width_up_to_the_limit_fits(kernel, dtype):
    """Every chain from the narrowest up to the wrapper's limit launches a
    block that fits one H100 SM: at most 1024 threads and 227 KB of shared
    memory (the limits themselves also carry the card's no-spill finding,
    `tools/width_scan.py`, which needs nvcc); the 7-DoF arm is within."""
    limits, first, geometry = LIMITS[kernel]
    top = limits[dtype]
    assert top >= (8 if kernel == "rollout_time1" else 7)
    for w in range(first, top + 1):
        g = geometry(w, dtype)
        assert g["threads"] <= 1024 and g["smem_bytes"] <= nvcc_build.SMEM_PER_BLOCK_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_riccati_max_nq_is_the_block_fit(dtype):
    """riccati's residual limit is the block's fit at the type's widest
    chain: one nq more needs more shared memory than one H100 SM gives a
    block."""
    top, n = riccati.MAX_NQ[dtype], riccati.MAX_N[dtype]
    assert top >= 13   # the widest residual of this repo's specs (hybrid)
    g = riccati.launch_geometry(64, dtype, n, top + 1)
    assert g["smem_bytes"] > nvcc_build.SMEM_PER_BLOCK_MAX


def test_geometry_matches_the_cuda_sources():
    """The wrappers' launch constants are the ones the CUDA sources define,
    and each source builds one width a library, named after it."""
    first = (CSRC / "segment_backward.cu").read_text()
    sb = segment_backward
    assert re.search(r"#define SB_LANES (\d+)", first).group(1) == str(
        sb.LANES_PER_BLOCK)
    assert re.search(r"#define SB_AHEAD (\d+)", first).group(1) == str(sb.STEPS_AHEAD)
    # one thread a lane: a block of kLanes threads
    assert "kernel<<<(B + kLanes - 1) / kLanes, kLanes," in first
    assert "SB_ENTRY_OF(SB_N, float, f32)" in first and "if (n != SB_N) return 1;" in first
    sweep = (CSRC / "segment_backward_2nd.cu").read_text()
    sb2 = segment_backward_2nd
    assert re.search(r"constexpr int kLanes = (\d+);", sweep).group(1) == str(
        sb2.LANES_PER_BLOCK["second"])
    # 'second': a thread a column of [Qux | Qu] and a spare, n + 2
    assert re.search(r"kGroup = N \+ 2", sweep)
    assert all(sb2.threads_per_lane("second", d) == 2 * d + 2 for d in DOFS)
    assert re.search(r"#define SECOND_AHEAD (\d+)", sweep).group(1) == str(
        sb2.STEPS_AHEAD["second"])
    assert re.search(r"#define TIME1_LANES (\d+)", sweep).group(1) == str(
        sb2.LANES_PER_BLOCK["time1"])
    assert re.search(r"#define TIME1_AHEAD (\d+)", sweep).group(1) == str(
        sb2.STEPS_AHEAD["time1"])
    # 'time1': a thread a column of [Qux | Qu], n + 1
    assert re.search(r"kGroup = N_ \+ 1", sweep)
    assert all(sb2.threads_per_lane("time1", d) == d + 2 for d in DOFS)
    assert "segment_backward_2nd_geometry(int kind, int width" in sweep
    ric = (CSRC / "riccati.cu").read_text()
    assert re.search(r"#define RICCATI_LANES (\d+)", ric).group(1) == str(
        riccati.LANES_PER_BLOCK)
    assert re.search(r"#define RICCATI_STEPS (\d+)", ric).group(1) == str(
        riccati.STEPS_PER_CHUNK)
    assert re.search(r"kThreads = \(N \+ 1\) \* kLanes", ric)
    assert riccati.launch_geometry(32, torch.float32, 6, 6)["threads"] == 7 * 32
    for t, tag in (("float", "f32"), ("double", "f64")):
        assert f"RICCATI_ENTRY_OF(RICCATI_N, RICCATI_NQ, {t}, {tag})" in ric
    assert "if (n != RICCATI_N || nq != RICCATI_NQ) return 1;" in ric
    roll = (CSRC / "rollout_time1.cu").read_text()
    assert re.search(r"#define ROLLOUT_LANES (\d+)", roll).group(1) == str(
        rollout_time1.LANES_PER_BLOCK)
    assert re.search(r"#define ROLLOUT_STAGES (\d+)", roll).group(1) == str(
        rollout_time1.RING_STAGES)
    assert "rollout_kernel<N, T><<<blocks, N * kLanes" in roll
    assert "if (n != ROLLOUT_N) return 1;" in roll
    lim = (CSRC / "limit_penalty.cu").read_text()
    assert re.search(r"#define LP_ARRAYS_THREADS (\d+)", lim).group(1) == str(
        limit_penalty.ARRAYS_THREADS)
    assert "const dim3 block(LX, TY);" in lim
    assert "<<<grid, kArraysThreads, 0, stream>>>" in lim
    for t, tag in (("float", "f32"), ("double", "f64")):
        assert f"LP_ENTRIES({t}, {tag})" in lim
