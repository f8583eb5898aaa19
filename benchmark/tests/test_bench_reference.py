"""The plain reference solves what the program solves: float64 on the CPU
at a small batch, both configurations, the program through its main entry
(`parallel.solve_batch`, the fleet solver with its kernels' twins)."""

import pytest
import torch

from benchmark import check, traffic
from benchmark.reference.precision import Precision, round_tf32

# Reduction order alone: float64 costs of sensitive lanes move by up to
# ~5e-10 relative (the flagship) and 2e-9 (the time-optimal kind).
COST_REL = 1e-8
STATE_ABS = 1e-7


@pytest.mark.parametrize("cell", ["posorn_h100.bulk", "timeopt_h100.bulk",
                                  "posorn_h100.replan"])
def test_reference_agrees_with_the_program_in_float64(cell, cell_of):
    c = cell_of(cell)
    cfg = dict(c.config, dtype="float64")
    mix = dict(c.mix, batch=6, pool=1)
    problem = c.problem()
    inp = traffic.Inputs(cfg, mix, 2**32 + 3, "cpu")
    prog = problem.program_solver(cfg, mix["nb_iter"], "cpu")(inp.batch(0), inp.U0)
    ref = check.solve_reference(problem, cfg, mix["nb_iter"], inp.batch(0), inp.U0, "cpu")
    assert torch.equal(prog["iterations"].long(), ref["iterations"])
    rel = (prog["cost"] - ref["cost"]).abs() / ref["cost"]
    assert float(rel.max()) < COST_REL
    assert float((prog["X"] - ref["X"]).abs().max()) < STATE_ABS
    assert float((prog["U"] - ref["U"]).abs().max()) < 1e-6


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000001,
                      float("inf"), float("nan")])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0 + 2**-10
    assert r[3] == -3.0 and torch.isinf(r[4]) and torch.isnan(r[5])
    bits = r[:4].view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
    p = Precision.control("cpu")
    a = torch.rand(5, 3, 3) + 0.5
    b = torch.rand(5, 3, 3) + 0.5
    assert torch.equal(p.mm(a, b), round_tf32(a) @ round_tf32(b))
    assert not torch.equal(p.mm(a, b), a @ b)
