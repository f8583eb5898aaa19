"""Port parity, per-scenario overrides of every Spec leaf through the
batch entry points other than `solve_batch`: every leaf of
tests/test_torch_f5.py per lane at once (on a plain and a sequential spec)
through `solve_batch_staged`, `solve_batch_al` (also one leaf at a time on
the plain spec) and `solve_batch_al_staged`, and one leaf at a time or all
at once through `solve_batch_gn` (BatchILQR and BatchILQRCP), against the
JAX package's, float64 on the CPU.

Tolerances: iterations (and alpha) equal per lane, cost rtol 1e-10, U atol
1e-9; the AL multipliers atol 1e-10.
"""

import numpy as np
import pytest
from test_torch_f5 import B, KP, LEAVES, H, _assert_matches, _overrides
from test_torch_f5 import problems  # noqa: F401  (the shared fixture)

from ilqr_planner_torch.parallel import (solve_batch, solve_batch_al,
                                         solve_batch_al_staged,
                                         solve_batch_gn, solve_batch_staged)
from ilqr_planner_torch.utils.convert import constraints_like

AL_ARGS = (5, 0.25, 1.1)          # lag_update_step, penalty, scaling_factor


ALL = {"plain": LEAVES, "sequential": LEAVES + ("Rt_top",)}


@pytest.mark.parametrize("kind", ["plain", "sequential"])
def test_staged_all_leaves_matches_jax(problems, kind):
    """Every leaf per lane at once through solve_batch_staged (first stage
    4 of 12 iterations, buckets of 2, early stop on) against the JAX
    package's staged solve, and the port's plain solve_batch."""
    from ilqr_planner_tpu.parallel import solve_batch_staged as jstaged

    jspec, spec = problems[kind]
    ov = _overrides(jspec, ALL[kind], seed=9)
    U0s = np.zeros((B, H - 1, 7))
    kw = dict(first_stage=4, bucket=2, prefer_fleet=False)
    ref = jstaged(jspec, ov, U0s, 12, **kw)
    got = solve_batch_staged(spec, ov, U0s, 12, **kw)
    _assert_matches(got, ref)
    plain = solve_batch(spec, ov, U0s, 12)
    assert bool((plain.iterations > 4).any())
    _assert_matches(got, plain)


@pytest.mark.parametrize("kind,name", [("plain", n) for n in LEAVES]
                         + [("sequential", "all")],
                         ids=[f"plain-{n}" for n in LEAVES] + ["sequential-all"])
def test_solve_batch_al_lane_leaf_matches_jax(problems, kind, name):
    """solve_batch_al (x5 <= 1.5 at every step, shared) with one leaf per
    lane, or every leaf at once on the sequential spec: the recursive AL
    route on both `prefer_fleet` against the JAX vmap route, 6 iterations
    (a dual update at 5)."""
    from ilqr_planner_tpu.parallel import solve_batch_al as jsolve
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints

    jspec, spec = problems[kind]
    ov = _overrides(jspec, ALL[kind] if name == "all" else (name,), seed=3)
    A = np.zeros((1, 14))
    A[0, 5] = 1.0
    jcons = Constraints.uniform(A, np.array([1.5]), H)
    cons = constraints_like(jcons, device="cpu")
    U0s = np.zeros((B, H - 1, 7))
    ref = jsolve(jspec, jcons, np.zeros(1), ov, U0s, 6, *AL_ARGS)
    for prefer in (True, False):
        got = solve_batch_al(spec, cons, np.zeros(1), ov, U0s, 6, *AL_ARGS,
                             prefer_fleet=prefer)
        _assert_matches(got, ref, alpha=False)
        np.testing.assert_allclose(got.multipliers.numpy(),
                                   np.asarray(ref.multipliers), atol=1e-10,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["plain", "sequential"])
def test_solve_batch_al_staged_all_leaves_matches_jax(problems, kind):
    """Every leaf per lane at once through solve_batch_al_staged (first
    stage 3 of 8 iterations, buckets of 2) against the JAX package's."""
    from ilqr_planner_tpu.parallel import solve_batch_al_staged as jstaged
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints

    jspec, spec = problems[kind]
    ov = _overrides(jspec, ALL[kind], seed=4)
    A = np.zeros((1, 14))
    A[0, 5] = 1.0
    jcons = Constraints.uniform(A, np.array([1.5]), H)
    U0s = np.zeros((B, H - 1, 7))
    kw = dict(first_stage=3, bucket=2)
    ref = jstaged(jspec, jcons, np.zeros(1), ov, U0s, 8, *AL_ARGS, **kw)
    got = solve_batch_al_staged(spec, constraints_like(jcons, device="cpu"),
                                np.zeros(1), ov, U0s, 8, *AL_ARGS, **kw)
    assert bool((got.iterations > 3).any())
    _assert_matches(got, ref, alpha=False)


GN_CASES = ([("plain", n, False) for n in LEAVES]
            + [("plain", "all", True), ("sequential", "all", False),
               ("sequential", "all", True)])


@pytest.mark.parametrize("kind,name,cp", GN_CASES,
                         ids=[f"{k}-{n}-{'cp' if c else 'gn'}"
                              for k, n, c in GN_CASES])
def test_solve_batch_gn_lane_leaf_matches_jax(problems, kind, name, cp):
    """solve_batch_gn (the closed-form body; BatchILQRCP with cp) with one
    leaf per lane, or every leaf at once, against the JAX package's: 10
    iterations, u atol 1e-9, cost rtol 1e-10. A per-lane dt builds each
    lane's closed-form Su."""
    from ilqr_planner_tpu.ops import primitives as jprim
    from ilqr_planner_tpu.parallel import solve_batch_gn as jsolve_gn

    jspec, spec = problems[kind]
    ov = _overrides(jspec, ALL[kind] if name == "all" else (name,), seed=7)
    kp = KP if kind == "plain" else (H // 2, H - 1)
    u0s = 0.01 * np.random.default_rng(2).normal(size=(B, (H - 1) * 7))
    psi = np.kron(jprim.build_psi_unitstep(H - 1, 3), np.eye(7)) if cp else None
    ref = jsolve_gn(jspec, kp, ov, u0s, 10, psi=psi)
    got = solve_batch_gn(spec, kp, ov, u0s, 10, psi=psi)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-9,
                               rtol=0)
