"""The generator: the same seed gives the same inputs, another seed other
ones, at seeds beyond 32 bits."""

import pytest
import torch

from benchmark import traffic

SEEDS = (0, 2**31 + 7, 2**33 + 5)


@pytest.mark.parametrize("cell", ["posorn_h100.bulk", "timeopt_h100.bulk",
                                  "posorn_h100.replan"])
def test_seeded_inputs(cell, cell_of):
    c = cell_of(cell)
    mix = dict(c.mix, batch=16, pool=3)
    made = [traffic.Inputs(c.config, mix, s, "cpu") for s in SEEDS]
    again = traffic.Inputs(c.config, mix, SEEDS[1], "cpu")
    assert torch.equal(made[1].x0, again.x0) and torch.equal(made[1].sample, again.sample)
    for a, b in zip(made, made[1:]):
        assert not torch.equal(a.x0, b.x0)
    x0 = made[0].x0
    n = len(c.config["q0_nominal"]) + len(c.config["x0_tail"])
    assert x0.shape == (3, 16, n) and x0.dtype == torch.float32
    assert not torch.equal(x0[0], x0[1])          # the pool's batches differ
    dq = x0[..., :len(c.config["q0_nominal"])] - torch.tensor(c.config["q0_nominal"])
    assert 0.02 < float(dq.std()) < 0.09          # 0.05 N(0, 1) a joint
    U0 = made[0].U0
    assert U0.shape == (16, c.config["horizon"] - 1, len(c.config["u0_row"]))
    assert torch.equal(U0[3, 7], torch.tensor(c.config["u0_row"], dtype=torch.float32))


def test_kept_lanes_are_a_seeded_subset(cell_of):
    c = cell_of("posorn_h100.replan")
    mix = dict(c.mix, batch=8, pool=2, sample_lanes_per_call=3, check_lanes=5)
    drawn = []
    for _ in range(2):
        inp = traffic.Inputs(c.config, mix, 99, "cpu")
        kept = traffic.Kept(inp)
        for k in range(3):
            x0 = inp.batch(k)
            out = {"X": x0[:, None].expand(-1, 4, -1), "U": x0[:, None, :2],
                   "cost": x0[:, 0], "iterations": torch.arange(8)}
            kept.keep(k, x0, out)
        drawn.append(kept.drawn())
    assert drawn[0]["x0"].shape[0] == 5
    assert torch.equal(drawn[0]["x0"], drawn[1]["x0"])
    assert torch.equal(drawn[0]["cost"], drawn[0]["x0"][:, 0])
