"""Keypoint tracking on a serial arm from a URDF: the program's problem and
the plain reference's, both from one configuration file.

`program_solver` builds the spec through the program's public API and
returns the call that the measured window drives
(`ilqr_planner_torch.parallel.solve_batch`). `reference_problem` states the
same problem for `benchmark/reference/ilqr.py`. Both read the same numbers
and the same URDF file; neither sees the other's objects.
"""

from pathlib import Path

import torch

from benchmark.reference.keypoint_problem import KeypointProblem

BENCH = Path(__file__).resolve().parents[1]


def urdf_path(cfg):
    return BENCH / cfg["urdf"]


def dims(cfg):
    """(dof, n, m, inner keypoint count) of the problem, with no program
    and no device."""
    dof = len(cfg["q0_nominal"])
    n = dof + (1 if cfg["kind"] == "posorn_time" else 0)
    inner = sum(int(kp["step"]) < cfg["horizon"] - 1 for kp in cfg["keypoints"])
    return dof, n, n, inner


def program_solver(cfg, nb_iter, device):
    """-> solve(x0s [B, n], U0s [B, H-1, m]) -> {"X", "U", "cost",
    "iterations"}, float32 tensors of the program on `device`."""
    from ilqr_planner_torch.models import Robot, chain_from_urdf
    from ilqr_planner_torch.parallel import solve_batch
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint, SpacetimeKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    dtype = getattr(torch, cfg["dtype"])
    robot = Robot.from_chain(chain_from_urdf(
        str(urdf_path(cfg)), cfg["base_link"], cfg["tip_link"], dtype=dtype,
        device=device, prefer_native=False))
    time_kind = cfg["kind"] == "posorn_time"
    kps = []
    for kp in cfg["keypoints"]:
        prec = torch.diag(torch.tensor(kp["precision_diag"], dtype=torch.float64)).numpy()
        if time_kind:
            kps.append(SpacetimeKeypoint(kp["position"], kp["orientation"], prec,
                                         kp["step"], kp["time"]))
        else:
            kps.append(PosOrnKeypoint(kp["position"], kp["orientation"], prec,
                                      kp["step"]))
    lim = cfg["joint_limits"]
    spec = make_spec(cfg["kind"], robot, kps, cfg["Rt"], cfg["horizon"], 1,
                     dt=None if time_kind else cfg["dt"], q0=cfg["q0_nominal"],
                     q_max=lim["max"], q_min=lim["min"], dtype=dtype, device=device)
    if float(spec.penalty) != float(lim["penalty"]):
        raise ValueError(f"the program's limit penalty is {float(spec.penalty)}, "
                         f"the configuration states {lim['penalty']}")
    dof = spec.dof

    def solve(x0s, U0s):
        res = solve_batch(spec, {"q0": x0s[:, :dof], "x0": x0s}, U0s, nb_iter)
        return {"X": res.X, "U": res.U, "cost": res.cost,
                "iterations": res.iterations}

    return solve


def reference_problem(cfg, prec):
    """The plain statement of the problem in precision `prec`."""
    return KeypointProblem(cfg, urdf_path(cfg), prec)
