"""Same-card A/B of one path's solve between two checkouts of this
repository (for example the parent commit unpacked with `git archive`, and
the working tree).

    python3 tools/flagship_ab.py ROOT_A ROOT_B [PATH]

Each run is a fresh process that imports the checkout's own `chip_smoke.py`
and runs the end-to-end phase of PATH (flagship, the default, or posorn2nd
or timeopt: the kernel build, one solve, 5 timed repeats at the path's full
batch, float32), in the order A, B, B, A. Prints one JSON line
per run and a summary line with each checkout's mean of its two medians.
Needs one CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys

CHILD = """
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
if {path!r} == "flagship":
    (getattr(cs, "phase_flagship", None) or cs.phase_end_to_end)(torch)
else:
    cs.phase_new_path(torch, {path!r})
"""


def run(root, path):
    proc = subprocess.run([sys.executable, "-c",
                           CHILD.format(root=root, path=path)],
                          cwd=root, capture_output=True, text=True, timeout=900,
                          check=False)
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"end_to_end"' in line:
            return json.loads(line)
    raise RuntimeError(f"no end-to-end line from {root} (exit "
                       f"{proc.returncode}):\n{proc.stderr[-4000:]}")


def main():
    roots = [os.path.abspath(r) for r in sys.argv[1:3]]
    if len(roots) != 2:
        sys.exit("usage: flagship_ab.py ROOT_A ROOT_B [PATH]")
    path = sys.argv[3] if len(sys.argv) > 3 else "flagship"
    medians = {r: [] for r in roots}
    for i, root in enumerate((roots[0], roots[1], roots[1], roots[0])):
        out = run(root, path)
        medians[root].append(out["solves_per_s_median"])
        print(json.dumps({"run": i, "root": root, "path": path,
                          "solves_per_s_median": out["solves_per_s_median"],
                          "repeat_times_s": out["repeat_times_s"],
                          "median_cost": out["median_cost"]}), flush=True)
    a, b = (statistics.mean(medians[r]) for r in roots)
    print(json.dumps({"summary": {"path": path, "A": roots[0], "B": roots[1],
                                  "A_solves_per_s": a, "B_solves_per_s": b,
                                  "B_over_A": b / a}}), flush=True)


if __name__ == "__main__":
    main()
