"""Whether the fleet and recursive routes differ on planar2d, or only round
otherwise, on the CPU in float64.

    python3 tools/route_gap.py

`chip_smoke.py` holds the two routes of `solve_batch` against each other
on 64 lanes of planar2d (a 3-link planar arm, H = 100, 10 iterations) and
lets a lane over 1e-8 relative pass within 10 times the larger of the two
routes' CPU spreads (a lane's cost move under a 1e-15 relative change of
its initial state). This script tests that rule's premise on the twins, in
three parts, each one JSON line:

  1. `batch_seeds`: the batch of seed 2 (the card's) and of seeds 3-6,
     64 lanes each: each lane's route gap, each route's spread under
     1e-15 (up and down) and under one ulp (up) of the initial state; the
     lanes over 1e-8 with their ratio gap / larger spread, and the
     largest gap among the lanes whose spreads stay under 1e-12;
  2. `lane_distribution`: the batch of seed 2 solved 10 times a route, each
     time with every initial state moved by 1e-15 N(0, 1) relative (noise
     seeds 0-9): for each lane over 1e-8 in part 1, the mean and standard
     deviation of its cost on each route, the gap of the means in units of
     the larger deviation, and the unmoved gap;
  3. `per_iteration`: that lane's recorded cost, iteration by iteration, on
     each route and on the fleet route from the moved initial state.

A route gap that grows from rounding level, tracks the spreads and sits
inside the two routes' overlapping distributions is the lane's
sensitivity; a systematic difference of the routes would show from the
first iterations and on lanes of small spread. It needs no card.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ilqr_planner_torch.parallel import solve_batch  # noqa: E402

LANES, NB_ITER, SEEDS, NOISE_SEEDS = 64, 10, (2, 3, 4, 5, 6), range(10)


def batch(seed):
    rng = np.random.default_rng(seed)
    q0s = cs.PLANAR_Q0[None] + 0.05 * rng.normal(size=(LANES, 3))
    return q0s, np.zeros((LANES, cs.H - 1, 3))


def solve(spec, q0s, U0s, fleet, record=False):
    return solve_batch(spec, {"x0": q0s}, U0s, NB_ITER, prefer_fleet=fleet,
                       record=record)


def rel(a, b):
    return np.abs(a - b) / np.abs(b)


def main():
    torch.set_num_threads(4)
    spec = cs.planar_spec(torch, torch.float64, "cpu")
    routes = {"fleet": True, "recursive": False}
    sensitive = {}
    out = []
    for seed in SEEDS:
        q0s, U0s = batch(seed)
        base = {r: solve(spec, q0s, U0s, f).cost.numpy() for r, f in routes.items()}
        gap = rel(base["recursive"], base["fleet"])
        spread = {r: np.zeros(LANES) for r in routes}
        ulp = {}
        for r, f in routes.items():
            for sign in (1.0, -1.0):
                moved = solve(spec, q0s * (1.0 + sign * cs.XCHECK_PERTURB), U0s, f)
                spread[r] = np.maximum(spread[r], rel(moved.cost.numpy(), base[r]))
            ulp[r] = rel(solve(spec, np.nextafter(q0s, np.inf), U0s, f).cost.numpy(),
                         base[r])
        both = np.maximum(spread["fleet"], spread["recursive"])
        quiet = both < 1e-12
        over = np.flatnonzero(gap > cs.XCHECK_REL)
        if seed == SEEDS[0]:
            sensitive = {int(i): float(gap[i]) for i in over}
        out.append({
            "seed": seed, "lanes_over_1e-8": [
                {"lane": int(i), "gap": float(gap[i]),
                 "spread_fleet": float(spread["fleet"][i]),
                 "spread_recursive": float(spread["recursive"][i]),
                 "ulp_move_fleet": float(ulp["fleet"][i]),
                 "ulp_move_recursive": float(ulp["recursive"][i]),
                 "gap_over_larger_spread": float(gap[i] / both[i])} for i in over],
            "max_gap_over_larger_spread": float(np.max(gap / np.maximum(both, 1e-300))),
            "lanes_spread_under_1e-12": int(quiet.sum()),
            "max_gap_where_spread_under_1e-12": float(gap[quiet].max()) if quiet.any()
            else None,
            "median_gap": float(np.median(gap))})
    print(json.dumps({"part": "batch_seeds", "seeds": out}), flush=True)

    q0s, U0s = batch(SEEDS[0])
    costs = {r: [] for r in routes}
    for ns in NOISE_SEEDS:
        noise = np.random.default_rng(100 + ns).normal(size=q0s.shape)
        q0n = q0s * (1.0 + cs.XCHECK_PERTURB * noise)
        for r, f in routes.items():
            costs[r].append(solve(spec, q0n, U0s, f).cost.numpy())
    costs = {r: np.array(c) for r, c in costs.items()}
    lanes = []
    for i, g in sorted(sensitive.items()):
        mean = {r: float(costs[r][:, i].mean()) for r in routes}
        std = {r: float(costs[r][:, i].std(ddof=1)) for r in routes}
        lanes.append({"lane": i, "unmoved_gap": g, "mean": mean, "std": std,
                      "rel_std": {r: std[r] / abs(mean[r]) for r in routes},
                      "mean_gap_in_larger_std": abs(mean["recursive"] - mean["fleet"])
                      / max(std.values())})
    print(json.dumps({"part": "lane_distribution", "noise": cs.XCHECK_PERTURB,
                      "noise_seeds": len(NOISE_SEEDS), "lanes": lanes}), flush=True)

    worst = max(sensitive, key=sensitive.get) if sensitive else 0
    rec = {r: solve(spec, q0s, U0s, f, record=True).progress["cost"][worst].numpy()
           for r, f in routes.items()}
    moved = solve(spec, q0s * (1.0 + cs.XCHECK_PERTURB), U0s, True,
                  record=True).progress["cost"][worst].numpy()
    print(json.dumps({
        "part": "per_iteration", "lane": worst,
        "route_gap": rel(rec["recursive"], rec["fleet"]).tolist(),
        "fleet_move_under_1e-15": rel(moved, rec["fleet"]).tolist(),
        "fleet_cost": rec["fleet"].tolist()}), flush=True)


if __name__ == "__main__":
    main()
