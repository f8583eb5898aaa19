"""One run of one cell of the benchmark of ilqr_planner_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. A run builds
the cell's problem through the program, draws its inputs on the card from
the seed, warms up at the cell's shapes (set-up), drives the program from
one client for `--seconds` (the window), and then:
  - with --trace 1, counts one untraced call and profiles one whole call;
  - solves a seeded sample of the window's lanes again with the plain
    reference (`reference/`, float64) and compares (`check.py`).
Its last line on standard output is one JSON object: `correct`,
`attempted` and `failed` (lanes of the window, and those whose cost is not
finite), `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with --trace 1 `breakdown`, and last `check`,
each compared number beside its limit; the same numbers are the last
lines on standard error. Earlier lines give the context: the card and its
power limit, the split of set-up, the window's sample counts, the host's
speed (`calib_s`), peak memory, the profiler's cost, each roofline's bound.

It exits non-zero and prints no result without a card (or with fewer than
the cell asks for), and if JAX or the JAX package was loaded.

The program's kernels are built with nvcc at first use into
`ilqr_planner_torch/build/` inside the checkout, so only the first run of a
checkout builds them. See README.md for how a later change adds a
configuration, a mix or a metric.
"""

import os
import time


def _process_age_s():
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


# set-up is timed from the process's start
T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that may not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "ilqr_planner_tpu")


def banned_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=False)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def emit(line, **kv):
    print(json.dumps({"line": line, **kv}), flush=True)


def _deciles(values):
    """min, the 10th to 90th percentiles, max."""
    import numpy as np

    return [float(v) for v in np.percentile(values, range(0, 101, 10))]


def timed_call(cell, device, control):
    """The call the window drives: the program, or with `control` the plain
    reference in float32 with TF32 products, in blocks of lanes."""
    from benchmark import check
    from benchmark.reference.precision import Precision

    mix, cfg, problem = cell.mix, cell.config, cell.problem()
    nb_iter = int(mix["nb_iter"])
    if not control:
        return problem.program_solver(cfg, nb_iter, device)
    prec = Precision.control(device)
    return lambda x0s, U0s: check.solve_reference(problem, cfg, nb_iter, x0s, U0s,
                                                  device, prec=prec, block=32768)


def run_cell(cell, seed, seconds, trace, device="cuda", control=False, wrap=None,
             t_start=None):
    """One run -> (the result's fields, the check's readings). `control`
    puts the control in the program's place and `wrap`, if given, wraps the
    timed call (`faults.py`): both only to show that the check fails them
    (`calibrate.py`, the tests), never a measurement."""
    import torch

    from benchmark import check, counters, profiling, traffic
    from benchmark.cells import Benchmark

    t_start = T_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    cfg, mix = cell.config, cell.mix
    problem = cell.problem()
    if cuda:
        from ilqr_planner_torch.utils.compilemeter import CompileMeter
        meter = CompileMeter()
    else:
        import contextlib
        meter = contextlib.nullcontext()
    marks = {"harness_ready_s": time.perf_counter() - t_start}
    with meter:
        call = timed_call(cell, device, control)
        if wrap is not None:
            call = wrap(call)
        marks["problem_built_s"] = time.perf_counter() - t_start
        inputs = traffic.Inputs(cfg, mix, seed, device)
        marks["inputs_drawn_s"] = time.perf_counter() - t_start
        traffic.warm_up(call, inputs, mix, device)
    setup_s = time.perf_counter() - t_start
    emit("setup", setup_s=setup_s, warmup_calls=mix["warmup_calls"], marks=marks,
         split=meter.report(wall_s=setup_s) if cuda else None)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = traffic.closed_loop(call, inputs, seconds, device,
                              count=None if control else lambda: counters.get("trials"))
    walls = win["walls"]
    emit("window", calls=win["calls"], lanes=win["lanes"], window_s=win["window_s"],
         failed=win["failed"], wall_deciles_s=_deciles(walls),
         trials_deciles=_deciles(win["counts"]))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    emit("memory", memory_peak_bytes=peak)
    if cuda:
        from ilqr_planner_torch.utils.calibprobe import calibration_probe
        emit("calibration", calib_s=calibration_probe(repeats=3, device=device),
             power=power_limit())

    ctx = {"config": cfg, "mix": mix, "dims": problem.dims(cfg), "walls": walls,
           "window_s": win["window_s"], "lanes": win["lanes"], "setup_s": setup_s}
    result = {"attempted": win["lanes"], "failed": win["failed"]}
    if trace:
        one = lambda: call(inputs.batch(0), inputs.U0)  # noqa: E731
        _, ctx["counts"] = counters.counted(lambda: (one(), traffic.sync(device)))
        tr = profiling.trace_call(one, device)
        ctx["trace"] = tr
        emit("profiler", profiler_s=tr.profiler_s, traced_wall_s=tr.wall_s,
             device_events=len(tr.device_events), kernels=len(tr.kernels()),
             busy_s=tr.busy_s, counts=ctx["counts"])
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        result["device_trace"] = {"busy_s": tr.busy_s, "window_s": tr.wall_s}
        metrics = cell.per_layer()
    else:
        metrics = cell.end_to_end()
    reported = {}
    for m in metrics:
        reader = Benchmark.reader("metrics" if trace else "endtoend", m["name"])
        if hasattr(reader, "bound"):
            emit("roofline", metric=m["name"], power_limit=power_limit(), **reader.bound(ctx))
        v = reader.read(ctx)
        if v is not None:
            reported[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = reported
    result["memory_peak_bytes"] = peak

    # the program's state goes before the reference runs
    kept = win["kept"].drawn()
    del call, win, ctx
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    S = kept["x0"].shape[0]
    ref = check.solve_reference(problem, cfg, int(mix["nb_iter"]), kept["x0"],
                                inputs.U0[0].expand(S, -1, -1), device)
    values = check.readings(kept, ref)
    emit("check", reference_s=time.perf_counter() - t0, **values)
    try:
        limits = cell.limits()
    except FileNotFoundError:
        print(f"run: no limits file {cell.limits_file}: not correct until one is set",
              file=sys.stderr)
        limits = None
    correct, compared = check.judge(values, limits, result["failed"])
    result["correct"] = correct
    result["check"] = compared
    return result, values


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    from benchmark.cells import Benchmark

    torch.set_num_threads(1)
    cell = Benchmark.load().cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    emit("device", name=torch.cuda.get_device_name(0), count=cell.chips,
         torch=torch.__version__, cuda=torch.version.cuda, seed=args.seed,
         seconds=args.seconds, trace=args.trace)
    res, _ = run_cell(cell, args.seed, args.seconds, args.trace, "cuda")
    found = banned_modules()
    if found:
        print(f"run: loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res.pop("memory_peak_bytes")}
    device.update(res.pop("device_trace", {}))
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["check"] = res["check"]
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
