"""Time design variants of the redesigned kernels on one card.

    python3 tools/kernel_variants.py [NAME=ROOT ...] [--only KERNEL,...]

Builds `csrc/segment_backward.cu` (n=7, H=100, B=36864: one thread a lane
at 32, 64 or 128 lanes a block, rows 1 or 2 steps ahead, the float32
register bound or none), `csrc/segment_backward_2nd.cu` ('second', n=14,
m=7, H=400, B=4096; 'time1', n=m=8, H=100, B=2048), `csrc/rollout_time1.cu`
(n=m=8, H=100, B=2048) and `csrc/riccati.cu` (n=7, nq=6, H=100, B=4096 and
B=36864) of this checkout at the 7-DoF widths with several settings of
their compile-time constants (-D: lanes a block, steps of rows in flight
and the register bound for the first-order sweep; the steps of rows in
flight and the lanes a block for the other sweeps; the lanes a block and
the ring stages for the rollout; the lanes a block and the steps a staged
chunk for riccati), and, for every NAME=ROOT given, the sources of another
checkout of this repository at ROOT (for example `parent=_archive/parent`,
the parent commit unpacked with `git archive`), whose entry points are
found by their names there (the width-named ones of this tree, or the older
one-width names). `--only` names the kernels to run (segment_backward,
sweep, time1, rollout, riccati_b4096, riccati_b36864; all by default).
Every variant runs on the seeded inputs of `chip_smoke.py` at the paths'
shapes: float64 against the plain twin (relative error), then CUDA-event
medians in float32 and float64 (one launch between the events, and ten back
to back, which leaves the host's enqueue time out), in the order of the
list and once more in reverse, so that each variant has two medians from
one call. Prints the card's name and power limit, each variant's ptxas
report and one JSON line a variant.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import nvcc_build  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2  # noqa: E402

P = ctypes.c_void_p
SB_VARIANTS = [("lanes32", ()),
               ("lanes32_ahead2", ("SB_AHEAD=2",)),
               ("lanes32_registers_free", ("SB_MIN_BLOCKS=1",)),
               ("lanes64", ("SB_LANES=64", "SB_MIN_BLOCKS=5")),
               ("lanes128", ("SB_LANES=128", "SB_MIN_BLOCKS=3"))]
SWEEP_VARIANTS = [("ahead2", ()), ("ahead1", ("SECOND_AHEAD=1",))]
TIME1_VARIANTS = [("lanes16_ahead2", ()),
                  ("lanes32_ahead2", ("TIME1_LANES=32",)),
                  ("lanes16_ahead1", ("TIME1_AHEAD=1",))]
RICCATI_VARIANTS = [("lanes32_steps1", ()),
                    ("lanes32_steps2", ("RICCATI_STEPS=2",)),
                    ("lanes16_steps1", ("RICCATI_LANES=16",))]
ROLLOUT_VARIANTS = [("lanes32_stages6", ()),
                    ("lanes32_stages2", ("ROLLOUT_STAGES=2",)),
                    ("lanes32_stages3", ("ROLLOUT_STAGES=3",)),
                    ("lanes32_stages8", ("ROLLOUT_STAGES=8",)),
                    ("lanes16_stages6", ("ROLLOUT_LANES=16",)),
                    ("lanes16_stages12", ("ROLLOUT_LANES=16", "ROLLOUT_STAGES=12"))]
TAGS = ((torch.float64, "f64"), (torch.float32, "f32"))
INNER = 10    # launches between two events of a back-to-back timing


def load_all(kernel, variants):
    """Build every (name, source, defines), all nvcc runs started together
    -> [(name, library)]."""
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda v: nvcc_build.build(v[1], v[2]), variants))
    for (name, source, defines), (_, report) in zip(variants, built):
        print(json.dumps({"kernel": kernel, "variant": name, "source": str(source),
                          "defines": defines,
                          "ptxas": nvcc_build.ptxas_summary(report)}), flush=True)
    return [(v[0], ctypes.CDLL(str(lib))) for v, (lib, _) in zip(variants, built)]


def sb_case():
    """The flagship's sweep: chip_smoke.py's inputs at n=7, H=100,
    B=36864, a keypoint at step 49."""
    hm1, kp, B, n = cs.H - 1, cs.KP_INNER, cs.B, cs.N
    Rt = [1e-5] * n
    args_np = cs.sweep_inputs(n, n, hm1, len(kp), B)
    case = {}
    for dtype, tag in TAGS:
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        slots, params = sb._launch_consts(hm1, kp, 0.1, 1e-6, tuple(Rt), dtype,
                                          args[0].device)
        ref = sb.segment_backward_reference(*args, kp, 0.1, Rt)
        out = tuple(torch.empty_like(r) for r in ref)
        case[tag] = (args + [slots, params], out, ref, (hm1, B))
    return case


def sweep_case(kind="second"):
    cfg = cs.PATHS["posorn2nd" if kind == "second" else "timeopt"]
    dt = 0.01 if kind == "second" else None
    n, m, hm1, kp, B = cfg["n"], cfg["m"], cfg["H"] - 1, cfg["kp_inner"], cfg["B"]
    Rt = [1e-5] * m
    args_np = cs.sweep_inputs(n, m, hm1, len(kp), B, seed=1)
    case = {}
    for dtype, tag in TAGS:
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        slots, params = sb2._launch_consts(kind, hm1, kp, dt, 1e-6, tuple(Rt),
                                           dtype, args[0].device)
        ref = sb2.segment_backward_2nd_reference(kind, *args, kp, dt, Rt)
        out = (torch.empty((hm1, m, n, B), dtype=dtype, device="cuda"),
               torch.empty((hm1, m, B), dtype=dtype, device="cuda"))
        case[tag] = (args + [slots, params], out, ref, (hm1, B))
    return case


def rollout_case():
    cfg = cs.PATHS["timeopt"]
    n, hm1, B = cfg["n"], cfg["H"] - 1, cfg["B"]
    args_np = cs.rollout_inputs(n, hm1, B)
    case = {}
    for dtype, tag in TAGS:
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        ref = rt1.rollout_time1_reference(0.5, *args)
        out = tuple(torch.empty_like(r) for r in ref)
        case[tag] = (args, out, ref, (hm1, B))
    return case


def riccati_case(batch):
    """The recursive path's riccati inputs (chip_smoke.py's, precisions at
    two steps) at `batch` lanes."""
    Rt = [1e-5] * cs.N
    args_np = cs.riccati_inputs(batch) + (cs.riccati_prec(False),)
    case = {}
    for dtype, tag in TAGS:
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        params = ric._params(0.1, 1e-6, tuple(Rt), dtype, args[0].device)
        ref = ric.riccati_backward_reference(*args, Rt, 0.1)
        out = tuple(torch.empty_like(r) for r in ref)
        case[tag] = (args + [params], out, ref, (cs.H, batch))
    return case


# each kernel's entry names at the 7-DoF width, this tree's first, then the
# older one-width names
NAMES = {"segment_backward": ("segment_backward_n7", "segment_backward"),
         "sweep": ("segment_backward_second_m7", "segment_backward_second"),
         "time1": ("segment_backward_time1_n8", "segment_backward_time1"),
         "rollout": ("rollout_time1_n8", "rollout_time1"),
         "riccati": ("riccati_backward_7x6", "riccati_backward")}
# the width defines of this tree's sources at the 7-DoF widths
WIDTH = {"segment_backward": ("SB_N=7",), "sweep": ("SECOND_M=7",),
         "time1": ("TIME1_N=8",), "rollout": ("ROLLOUT_N=8",),
         "riccati": ("RICCATI_N=7", "RICCATI_NQ=6")}


def entry(lib, kernel, tag):
    key = "riccati" if kernel.startswith("riccati") else kernel
    name = next(f"{n}_{tag}" for n in NAMES[key] if hasattr(lib, f"{n}_{tag}"))
    fn = getattr(lib, name)
    if kernel in ("segment_backward", "sweep", "time1"):
        fn.argtypes = [P] * 10 + [ctypes.c_int, ctypes.c_int, P]
    elif kernel.startswith("riccati"):
        fn.argtypes = [P] * 9 + [ctypes.c_int, ctypes.c_int, P]
    else:
        fn.argtypes = ([P] * 5 + [ctypes.c_float if tag == "f32" else ctypes.c_double]
                       + [P] * 3 + [ctypes.c_int, ctypes.c_int, P])
    fn.restype = ctypes.c_int
    return fn


def caller(fn, kernel, args, out, dims):
    ptrs = [a.data_ptr() for a in args]
    outs = [o.data_ptr() for o in out]
    if kernel == "rollout":
        ptrs = ptrs + [0.5]

    def call():
        err = fn(*ptrs, *outs, *dims, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    argv = sys.argv[1:]
    only = None
    if "--only" in argv:
        i = argv.index("--only")
        only = set(argv[i + 1].split(","))
        del argv[i:i + 2]
    others = [arg.split("=", 1) for arg in argv]
    for kernel, src, variants, make in (
            ("segment_backward", sb.SOURCE, SB_VARIANTS, sb_case),
            ("sweep", sb2.SOURCE, SWEEP_VARIANTS, sweep_case),
            ("time1", sb2.SOURCE, TIME1_VARIANTS, lambda: sweep_case("time1")),
            ("rollout", rt1.SOURCE, ROLLOUT_VARIANTS, rollout_case),
            ("riccati_b4096", ric.SOURCE, RICCATI_VARIANTS,
             lambda: riccati_case(cs.REC_B)),
            ("riccati_b36864", ric.SOURCE, RICCATI_VARIANTS,
             lambda: riccati_case(cs.B))):
        if only is not None and kernel not in only:
            continue
        width = WIDTH["riccati" if kernel.startswith("riccati") else kernel]
        todo = [(name, src, width + defs) for name, defs in variants]
        todo += [(name, os.path.join(os.path.abspath(root), os.path.relpath(src, REPO)),
                  width) for name, root in others]
        libs = load_all(kernel, todo)
        case = make()
        rows = {name: {"kernel": kernel, "variant": name} for name, _ in libs}
        for name, lib in libs:    # the launch, where the library reports it
            if kernel == "segment_backward" and hasattr(lib, "segment_backward_geometry"):
                fn = lib.segment_backward_geometry
                fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
                rows[name]["launch"] = {
                    tag: nvcc_build.kernel_geometry(fn, cs.N, size, cs.B)
                    for tag, size in (("f32", 4), ("f64", 8))}
        for order in (libs, libs[::-1]):
            for name, lib in order:
                for _, tag in TAGS:
                    args, out, ref, dims = case[tag]
                    call = caller(entry(lib, kernel, tag), kernel, args, out, dims)
                    for o in out:
                        o.fill_(float("nan"))
                    call()
                    torch.cuda.synchronize()
                    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
                    scale = max(float(r.abs().max()) for r in ref)
                    rows[name][f"rel_err_{tag}"] = err / scale
                    rows[name].setdefault(f"ms_{tag}", []).append(
                        cs.cuda_ms(torch, call, reps=20))
                    rows[name].setdefault(f"ms_back_to_back_{tag}", []).append(
                        cs.cuda_ms(torch, call, reps=10, inner=INNER))
        for row in rows.values():
            print(json.dumps(row), flush=True)
        del case
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
