"""Build every chain width of each CUDA kernel and find the largest each
source takes, on a machine with nvcc.

    python3 tools/width_scan.py              # every kernel's chain width
    python3 tools/width_scan.py riccati_nq   # riccati's residual width nq

For each kernel (segment_backward by n; 'second' and 'time1' by DoF; the
rollout by n = DoF + 1; riccati by n at each residual width nq = 6, n, 3)
it builds the widths in rising order, from 1 up to the largest whose block
fits one H100 SM (the wrapper's `launch_geometry`: at most 1024 threads and
227 KB of shared memory), and reads each instantiation's registers and
spills from ptxas. Every chain up to the 7-DoF arm's width is taken (a
spill there is reported: it costs time, not the answer); a wider one counts
for a type where it and every width between the arm's and it fit and build
without a spill. The kernels' chains are built side by side, one nvcc each.
Prints one JSON line a build and, last, the largest width of each kernel
and type, which the wrappers' MAX_N / MAX_DOF state (riccati: the least of
its three residual widths).

With `riccati_nq` it scans riccati's residual width instead: every nq up
to the wrapper's MAX_NQ (the block's fit at MAX_N, computed without a card:
float32 45, float64 35) at n = 3, 7 and each type's MAX_N, eight builds at
a time (a failed build stops it). It prints each build's registers and
spills, lists the admitted widths of each type that spill, and times
what a spill costs: the kernel at n = 7 on the flagship's batch (B = 4096,
H = 100, precisions at two steps) at nq = 7 (no spill), 8 (float32 spills)
and 9 (no spill), both types, CUDA events over ten launches, median of
five.
"""

import json
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ilqr_planner_torch.ops.cuda_kernels import nvcc_build  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2  # noqa: E402

TYPES = {"f32": torch.float32, "f64": torch.float64}


def fits(g):
    return g["threads"] <= 1024 and g["smem_bytes"] <= nvcc_build.SMEM_PER_BLOCK_MAX


def spills(report):
    """Bytes of spill stores + loads by type ('f' or 'd' in each kernel's
    mangled template arguments), from a ptxas report."""
    out, kind = {"f32": 0, "f64": 0}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"[IE]([fd])[LE]", m.group(1))
            kind = None if t is None else ("f32" if t.group(1) == "f" else "f64")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kind:
            out[kind] += int(m.group(1)) + int(m.group(2))
    return out


# kernel -> (first width, the 7-DoF arm's, geometry of a width in a type,
# build of a width)
CHAINS = {
    "segment_backward": (1, 7, lambda w, dt: sb.launch_geometry(64, dt, w),
                         lambda w: sb.build(w)),
    "second": (1, 7, lambda w, dt: sb2.launch_geometry("second", 64, dt, w),
               lambda w: sb2.build("second", w)),
    "time1": (1, 7, lambda w, dt: sb2.launch_geometry("time1", 64, dt, w),
              lambda w: sb2.build("time1", w)),
    "rollout_time1": (2, 8, lambda w, dt: rt1.launch_geometry(64, dt, w),
                      lambda w: rt1.build(w)),
}
for label, nq_of in (("riccati_posorn", lambda n: 6), ("riccati_joint", lambda n: n),
                     ("riccati_point", lambda n: 3)):
    CHAINS[label] = (1, 7, lambda w, dt, f=nq_of: ric.launch_geometry(64, dt, w, f(w)),
                     lambda w, f=nq_of: ric.build(w, f(w)))


def chain(name):
    first, arm, geometry, build = CHAINS[name]
    top = {tag: first - 1 for tag in TYPES}
    open_ = set(TYPES)
    w = first
    while open_:
        ok = {tag for tag in open_ if fits(geometry(w, TYPES[tag]))}
        if not ok:
            break
        t0 = time.time()
        _, report = build(w)
        sp = spills(report)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        print(json.dumps({"kernel": name, "width": w, "build_s": time.time() - t0,
                          "registers": regs, "spill_bytes": sp}), flush=True)
        for tag in list(open_):
            if tag in ok and (sp[tag] == 0 or w <= arm):
                top[tag] = w
            else:
                open_.discard(tag)
        w += 1
    return top


SPILL_NQ = (7, 8, 9)


def spill_cost():
    """Kernel ms at n = 7, nq in SPILL_NQ, B = 4096, H = 100, both types."""
    import statistics

    B, H, n = 4096, 100, 7
    g = torch.Generator().manual_seed(0)
    out = {}
    for tag, dtype in TYPES.items():
        for nq in SPILL_NQ:
            def r(*shape):
                return torch.randn(*shape, generator=g, dtype=torch.float64).to(
                    dtype=dtype, device="cuda")
            prec = torch.zeros((H, nq, nq), dtype=dtype, device="cuda")
            prec[[H // 2, H - 1]] = torch.eye(nq, dtype=dtype, device="cuda")
            args = (0.1 * r(B, H, nq, n), 0.01 * r(B, H, nq),
                    torch.zeros((B, H, n), dtype=dtype, device="cuda"),
                    torch.zeros((B, H, n), dtype=dtype, device="cuda"),
                    0.1 * r(B, H - 1, n), prec)
            for _ in range(3):
                ric.riccati_backward(*args, [1e-5] * n, 0.1)
            times = []
            for _ in range(5):
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                for _ in range(10):
                    ric.riccati_backward(*args, [1e-5] * n, 0.1)
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1) / 10)
            out[f"{tag} 7x{nq}"] = statistics.median(times)
    return out


def riccati_nq():
    ns = sorted({3, 7, *ric.MAX_N.values()})
    top_nq = max(ric.MAX_NQ.values())
    jobs = [(n, nq) for nq in range(1, top_nq + 1) for n in ns]

    def build(job):
        t0 = time.time()
        _, report = ric.build(*job)
        return job, report, time.time() - t0

    with ThreadPoolExecutor(8) as ex:
        reports = {}
        for (n, nq), report, secs in ex.map(build, jobs):
            reports[n, nq] = report
            print(json.dumps({
                "kernel": "riccati", "n": n, "nq": nq, "build_s": secs,
                "registers": [int(r) for r in
                              re.findall(r"Used (\d+) registers", report)],
                "spill_bytes": spills(report)}), flush=True)
    spilled = {tag: [[n, nq] for n in ns for nq in range(1, ric.MAX_NQ[dtype] + 1)
                     if n <= ric.MAX_N[dtype] and spills(reports[n, nq])[tag]]
               for tag, dtype in TYPES.items()}
    print(json.dumps({"max_nq": {tag: ric.MAX_NQ[dtype]
                                 for tag, dtype in TYPES.items()},
                      "n_scanned": ns, "spilling_widths": spilled,
                      "spill_cost_kernel_ms": spill_cost(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def main():
    if sys.argv[1:] == ["riccati_nq"]:
        riccati_nq()
        return
    with ThreadPoolExecutor(len(CHAINS)) as ex:
        tops = dict(zip(CHAINS, ex.map(chain, CHAINS)))
    print(json.dumps({"largest_width": tops}), flush=True)


if __name__ == "__main__":
    main()
