"""The program's own counters, read around one untraced call.

Each is an exact count kept by the program: kernel launches by wrapper and
the fleet's line-search trials."""

COUNTERS = {
    "segment_backward": ("ilqr_planner_torch.ops.cuda_kernels.segment_backward", "LAUNCHES", None),
    "segment_backward_2nd": ("ilqr_planner_torch.ops.cuda_kernels.segment_backward_2nd",
                             "LAUNCHES", "second"),
    "segment_backward_time1": ("ilqr_planner_torch.ops.cuda_kernels.segment_backward_2nd",
                               "LAUNCHES", "time1"),
    "rollout_time1": ("ilqr_planner_torch.ops.cuda_kernels.rollout_time1", "LAUNCHES", None),
    "riccati": ("ilqr_planner_torch.ops.cuda_kernels.riccati", "LAUNCHES", None),
    "trials": ("ilqr_planner_torch.solvers.fleet", "TRIALS", None),
    "generic_sweeps": ("ilqr_planner_torch.solvers.fleet", "GENERIC_SWEEPS", None),
}


def get(name):
    import importlib

    mod, attr, key = COUNTERS[name]
    value = getattr(importlib.import_module(mod), attr)
    return value[key] if key is not None else value


def counted(fn):
    """fn() -> (its result, {counter: count during the call})."""
    before = {k: get(k) for k in COUNTERS}
    out = fn()
    return out, {k: get(k) - before[k] for k in COUNTERS}
