"""How far the dense Riccati recursion amplifies rounding, on the CPU.

    python3 tools/riccati_rounding.py

The value update P' = l_xx + P + K'Quu K + K'Qux + Qux'K of the recursive
solver's structured backward pass does not symmetrize P. Its antisymmetric
rounding residue A grows by A' = A (1 + (a / (a + r))^2) a step, a = dt^2 P,
r = Rt: it doubles wherever dt^2 P dominates Rt, which is the case after a
keypoint or an active joint limit. This script runs the port's plain twin
(`riccati_backward_reference`, explicit Gauss-Jordan inverse) and the same
recursion with an LU solve in float64 at H = 100, n = 7, nq = 6, 64 lanes,
on the seeded inputs of `chip_smoke.py` (its generator and its LU
recursion, so the card's lines and these are of the same inputs), for
precisions at two steps or at every step and for several densities of the
limit penalty, and prints one JSON line a case: the largest antisymmetric
entry of P along the sweep, the relative difference of the gains between
the two orders of summation, and float32 against float64 (null: not
finite). It needs no card.
"""

import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ilqr_planner_torch.ops.cuda_kernels.riccati import (  # noqa: E402
    riccati_backward_reference)

LANES = 64


def main():
    Rt = [1e-5] * cs.N
    for name, dense, weight in (("two_steps", False, 1.0),
                                ("every_step_1e-4", True, 1e-4),
                                ("every_step_unit", True, 1.0)):
        for limit_frac in (0.0, 0.005, 0.05, 0.2):
            args = [torch.as_tensor(a) for a in
                    cs.riccati_inputs(LANES, limit_frac)
                    + (cs.riccati_prec(dense, weight),)]
            K, _ = riccati_backward_reference(*args, Rt, 0.1)
            K_lu, asym = cs.riccati_lu_sweep(torch, args[0], args[2], args[5])
            K32, _ = riccati_backward_reference(*(a.float() for a in args),
                                                Rt, 0.1)
            print(json.dumps({
                "precisions": name, "limit_frac": limit_frac,
                "max_asym_P": asym if math.isfinite(asym) else None,
                "gauss_jordan_vs_lu_rel": cs.rel_diff(K, K_lu),
                "f32_vs_f64_rel": cs.rel_diff(K32.double(), K)}), flush=True)


if __name__ == "__main__":
    main()
