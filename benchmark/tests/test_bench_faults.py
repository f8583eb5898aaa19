"""The check fails a broken timed path: a run driven on the CPU at a small
batch, with the harness's look for a card skipped, once for each fault a
solve can have (`faults.py`), reads `correct` false; the sound run and the
control are held to the same limits, and so is a window with a lane whose
cost is not finite."""

import pytest

from benchmark import check, faults, run

SMALL = dict(batch=8, pool=2, sample_lanes_per_call=4, check_lanes=16, warmup_calls=1)


@pytest.fixture
def small(cell_of):
    """name -> the cell at a small batch."""
    def get(name):
        c = cell_of(name)
        c.mix = dict(c.mix, **SMALL)
        return c
    return get


@pytest.mark.parametrize("cell", ["posorn_h100.replan", "posorn_h100.bulk",
                                  "timeopt_h100.bulk"])
@pytest.mark.parametrize("kind", faults.KINDS)
def test_fault_fails_the_check(cell, kind, small):
    c = small(cell)
    if cell.endswith("bulk"):
        c.mix = dict(c.mix, nb_iter=4)     # the bulk budgets are slow on a CPU
    res, values = run.run_cell(c, 77, 0.0, 0, device="cpu",
                               wrap=faults.wrap(kind, c, "cpu"))
    assert res["correct"] is False, values


def test_sound_run_and_control(small):
    c = small("posorn_h100.replan")
    res, values = run.run_cell(c, 78, 0.0, 0, device="cpu")
    assert res["correct"] is True, values
    res, values = run.run_cell(small("posorn_h100.replan"), 79, 0.0, 0, device="cpu",
                               control=True)
    assert res["correct"] is False, values


def test_a_nonfinite_cost_in_the_window_fails(small):
    c = small("posorn_h100.replan")

    def one_nan(call):
        def broken(x0s, U0s):
            out = call(x0s, U0s)
            cost = out["cost"].clone()
            cost[0] = float("nan")
            return dict(out, cost=cost)
        return broken

    res, _ = run.run_cell(c, 80, 0.0, 0, device="cpu", wrap=one_nan)
    assert res["failed"] >= 1 and res["correct"] is False
    assert res["check"]["failed"] == {"value": res["failed"], "limit": 0}


def test_judge_counts_the_window_not_only_the_sample():
    limits = {"compare": {"cost_rel_max": {"limit": 1.0}}}
    values = {"cost_rel_max": 0.1, "nonfinite": 0.0}
    assert check.judge(values, limits, failed=0)[0] is True
    ok, compared = check.judge(values, limits, failed=3)
    assert ok is False and compared["failed"] == {"value": 3, "limit": 0}
    assert check.judge(values, None, failed=0)[0] is False
