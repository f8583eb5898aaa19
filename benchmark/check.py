"""The comparison that decides `correct`.

The kept answers of the window (starts, X, U, cost, iterations of a seeded
sample of lanes) are solved again by the plain reference in float64 from
the same starts and initial controls, in blocks of lanes, and each number
below is read over the sample:

  cost_rel_max     max over lanes of |cost - cost_ref| / max(cost_ref,
                   the sample's median cost_ref): a lane whose reference
                   cost is near zero is held to the typical cost's scale;
  cost_rel_p90     the 90th percentile of the same;
  x_abs_max        max over lanes, steps and coordinates of |X - X_ref|;
  u_abs_max        the same for U;
  x_abs_p90        the 90th percentile over lanes of each lane's largest
                   |X - X_ref| (steady where a few lanes settle in another
                   local minimum and set the max);
  u_abs_p90        the same for U;
  iters_diff_share the share of lanes whose iteration count differs;
  nonfinite        lanes with a cost, X or U that is not finite (the
                   gaps above are read over the other lanes).

The cell's limits (`limits/<cell>.json`) name the numbers compared and the
limit of each, with the readings each limit was set from; a number read
but not named there is printed, not compared. Besides, every lane of the
window counts: `failed`, the window's lanes whose cost is not finite, has
the limit 0, as `nonfinite` has over the sample.
"""

import numpy as np
import torch

from benchmark.reference import ilqr
from benchmark.reference.precision import Precision


def solve_reference(problem_mod, cfg, nb_iter, x0, U0, device, prec=None, block=4096):
    """The reference's answers for starts x0 [S, n], initial controls U0
    [S, H-1, m] (any float dtype; cast to the reference's), in blocks."""
    prec = prec or Precision.reference(device)
    problem = problem_mod.reference_problem(cfg, prec)
    parts = []
    for i in range(0, x0.shape[0], block):
        parts.append(ilqr.solve(problem, prec.tensor(x0[i:i + block]),
                                prec.tensor(U0[i:i + block]), nb_iter))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def readings(kept, ref):
    """The numbers of the comparison, as floats. The gaps are read over the
    lanes whose answer is finite (NaN where none is); `nonfinite` counts
    the others."""
    d = torch.float64
    c, cr = kept["cost"].to(d), ref["cost"].to(d)
    X, U = kept["X"].to(d), kept["U"].to(d)
    finite = (torch.isfinite(c) & torch.isfinite(X).flatten(1).all(1)
              & torch.isfinite(U).flatten(1).all(1))
    scale = torch.maximum(cr.abs(), cr.abs().median())
    rel = ((c - cr).abs() / scale)[finite].cpu().numpy()
    x_lane = (X - ref["X"]).abs().flatten(1).amax(1)[finite].cpu().numpy()
    u_lane = (U - ref["U"]).abs().flatten(1).amax(1)[finite].cpu().numpy()
    some = rel.size > 0
    return {
        "cost_rel_max": float(np.max(rel)) if some else float("nan"),
        "cost_rel_p90": float(np.percentile(rel, 90)) if some else float("nan"),
        "x_abs_max": float(np.max(x_lane)) if some else float("nan"),
        "u_abs_max": float(np.max(u_lane)) if some else float("nan"),
        "x_abs_p90": float(np.percentile(x_lane, 90)) if some else float("nan"),
        "u_abs_p90": float(np.percentile(u_lane, 90)) if some else float("nan"),
        "iters_diff_share": float((kept["iterations"].cpu()
                                   != ref["iterations"].cpu()).double().mean()),
        "nonfinite": float((~finite).sum()),
        "lanes": float(c.shape[0]),
    }


def judge(values, limits, failed):
    """-> (correct, {name: {"value", "limit"}}) for each number the limits
    name, then `nonfinite` and `failed` (the window's lanes whose cost is
    not finite). A number that is NaN fails; so does any non-finite answer
    in the sample or the window, and a cell with no limits (None) is never
    correct."""
    compared = {}
    ok = values["nonfinite"] == 0 and failed == 0 and limits is not None
    for name, lim in (limits or {"compare": {}})["compare"].items():
        v = values[name]
        compared[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and bool(v <= lim["limit"])
    compared["nonfinite"] = {"value": values["nonfinite"], "limit": 0}
    compared["failed"] = {"value": failed, "limit": 0}
    return bool(ok), compared
