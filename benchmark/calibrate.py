"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --faults unchanged,half,altered \
        --fault-seeds 201,202,203 --seconds 3 [--lanes-per-call N]

Runs the cell as `run.py` does, at its own batch and iteration budget, once
a seed: the program on each of `--seeds`; the control (the plain reference
in float32 with TF32 products in the program's place) on each of
`--control-seeds`; and the program with each fault of `--faults`
(`faults.py`) planted under the timed call on each of `--fault-seeds`. It
prints each run's readings of the check (`check.py`) as one JSON line. No
call warms up first: the readings do not depend on it. A short window
keeps as many lanes as a full run when `--lanes-per-call` raises the lanes
kept of each call. The lower reading of a number is the largest over the
program's seeds, the upper the smallest over the control's
(`limits/<cell>.json` records both); each fault has to fail the check. A
run that crashes (the control's solve can meet a singular matrix) prints
`crashed` and no readings: it has failed and sets no upper reading.
This is the only entry to the control and the faults. Needs the card.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--lanes-per-call", type=int, default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    from benchmark import faults, run
    from benchmark.cells import Benchmark

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    runs = [(s, "program") for s in _ints(args.seeds)]
    runs += [(s, "control") for s in _ints(args.control_seeds)]
    runs += [(s, kind) for kind in args.faults.split(",") if kind
             for s in _ints(args.fault_seeds)]
    for seed, what in runs:
        cell = Benchmark.load().cell(args.workload)
        cell.mix = dict(cell.mix, warmup_calls=0)
        if args.lanes_per_call:
            cell.mix["sample_lanes_per_call"] = args.lanes_per_call
        wrap = faults.wrap(what, cell, "cuda") if what in faults.KINDS else None
        t0 = time.perf_counter()
        try:
            res, values = run.run_cell(cell, seed, args.seconds, 0, "cuda",
                                       control=what == "control", wrap=wrap, t_start=t0)
        except Exception as e:      # a run that crashes has failed, and reads nothing
            print(json.dumps({"reading": args.workload, "seed": seed, "run": what,
                              "correct": False, "crashed": f"{type(e).__name__}: {e}",
                              "run_s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
            continue
        print(json.dumps({"reading": args.workload, "seed": seed, "run": what,
                          "correct": res["correct"], "failed": res["failed"],
                          "attempted": res["attempted"],
                          "run_s": time.perf_counter() - t0, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
