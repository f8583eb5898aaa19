"""Build every chain width of each CUDA kernel and find the largest each
source takes, on a machine with nvcc.

    python3 tools/width_scan.py

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


def main():
    with ThreadPoolExecutor(len(CHAINS)) as ex:
        tops = dict(zip(CHAINS, ex.map(chain, CHAINS)))
    print(json.dumps({"largest_width": tops}), flush=True)


if __name__ == "__main__":
    main()
