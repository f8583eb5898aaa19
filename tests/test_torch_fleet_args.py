"""Port parity, the fleet solvers' knobs: `make_fleet_solver(rollout=)` and
`make_fleet_solver_al(ls=, backward=)` against the JAX package's, float64
on the CPU (where the port's sweeps and rollouts run the kernels' twins).

The AL fleet with the line search forced (ls='scan': one closed-loop
rollout a trial; ls='affine': the affine trial family) on the tutorial's
LTI problem under its folded bound, against the JAX AL fleet with the same
ls: iterations equal, cost rtol 1e-10, U atol 1e-9, multipliers atol
1e-10 (the AL result carries no alpha in either package). The
time-optimal fleet with rollout='auto' against the JAX fleet's: the
tolerances of tests/test_torch_fleet_2nd.py. ls='affine' on a time-optimal
kind raises in both packages; a backward or rollout other than 'auto'
raises in the port, which has one implementation of each.
"""

import numpy as np
import pytest
from test_torch_al import AL_ARGS, X5, _jax_cons, _jax_spec, _lanes
from test_torch_fleet_2nd import _assert_matches, _batch, _specs

from ilqr_planner_torch.solvers import al_ilqr, fleet
from ilqr_planner_torch.utils.convert import constraints_like, spec_like


@pytest.fixture(scope="module")
def lti_al():
    jspec = _jax_spec(1)
    jcons = _jax_cons(X5, [1.5])
    return jspec, jcons, spec_like(jspec, device="cpu"), constraints_like(
        jcons, device="cpu")


@pytest.mark.parametrize("ls", ["scan", "affine"])
def test_al_fleet_line_search_matches_jax(lti_al, ls):
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver_al as jmake

    jspec, jcons, spec, cons = lti_al
    _, x0s, U0s = _lanes(spec.nx)
    ref = jmake(jspec, jcons, 6, *AL_ARGS, ls=ls, backward="xla")(
        x0s, U0s, np.zeros(1))
    before = fleet.TRIALS
    got = fleet.make_fleet_solver_al(spec, cons, 6, *AL_ARGS, ls=ls)(
        x0s, U0s, np.zeros(1))
    assert fleet.TRIALS > before
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(got.multipliers.numpy(),
                               np.asarray(ref.multipliers), atol=1e-10, rtol=0)


def test_al_fleet_affine_on_time_optimal_kind_raises():
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints as JConstraints
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver_al as jmake

    jspec, spec = _specs("posorn_time", 1)
    A, b = np.zeros((1, spec.nx + spec.nu)), np.ones(1)
    jcons = JConstraints.uniform(A, b, spec.horizon)
    cons = al_ilqr.Constraints.uniform(A, b, spec.horizon, device="cpu")
    with pytest.raises(ValueError, match="ls='affine' requires LTI dynamics"):
        jmake(jspec, jcons, 2, *AL_ARGS, ls="affine")
    with pytest.raises(ValueError, match="ls='affine' requires LTI dynamics"):
        fleet.make_fleet_solver_al(spec, cons, 2, *AL_ARGS, ls="affine")
    with pytest.raises(ValueError, match="ls must be auto/affine/scan"):
        fleet.make_fleet_solver_al(spec, cons, 2, *AL_ARGS, ls="pscan")
    with pytest.raises(ValueError, match="backward must be 'auto' in the port"):
        fleet.make_fleet_solver_al(spec, cons, 2, *AL_ARGS, backward="xla")


def test_rollout_auto_matches_jax_on_time_optimal_kind():
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    jspec, spec = _specs("posorn_time", 1)
    x0s, U0s = _batch(spec, seed=3)
    ref = jmake(jspec, 4, backward="xla", rollout="auto")(x0s, U0s)
    _assert_matches(fleet.make_fleet_solver(spec, 4, rollout="auto")(x0s, U0s),
                    ref)
    for knob in ("rollout", "backward"):
        with pytest.raises(ValueError, match=f"{knob} must be 'auto' in the port"):
            fleet.make_fleet_solver(spec, 4, **{knob: "xla"})
