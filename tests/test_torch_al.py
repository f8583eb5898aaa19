"""Port parity, AL-iLQR: ilqr_planner_torch's `solvers/al_ilqr.py`,
`fleet.make_fleet_solver_al`, `parallel.solve_batch_al` and
`solve_batch_al_staged` against the JAX package's, float64 on the CPU
(where the fleet's backward runs the kernels' twins).

Tolerances are the JAX package's own for its fleet against its recursive
AL solver: at 6 iterations cost rtol 1e-9, U atol 1e-8, multipliers atol
1e-10; at 12 iterations (two dual updates) cost rtol 1e-6, multipliers
atol 1e-8. The per-step pieces at 1e-12 (`_backward_core_al`: of the
largest gain).
"""

import inspect
import types

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.parallel import solve_batch_al, solve_batch_al_staged
from ilqr_planner_torch.solvers import al_ilqr, fleet
from ilqr_planner_torch.utils.convert import constraints_like, spec_like

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
H, B = 40, 4
AL_ARGS = (5, 0.25, 1.1)          # lag_update_step, penalty, scaling_factor


def _jax_robot():
    from ilqr_planner_tpu.models import Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


def _jax_spec(nb_deriv):
    """The tutorial's posorn problem cut to H=40: targets at 19 and 39,
    dt=0.01, limits +-10 pi (the double integrator with zero velocity
    targets and velocity limits +-10)."""
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    qmax = np.ones(7) * np.pi * 10
    if nb_deriv == 1:
        qd = np.diag([1, 1, 1, .1, .1, .1])
        kps = [PosOrnKeypoint(*T, qd, k) for T, k in ((T1, H // 2 - 1), (T2, H - 1))]
        return make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, H, 1,
                         dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax,
                         dtype=np.float64)
    qd = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0])
    kps = [PosOrnKeypoint(*T, qd, k, dposition=[0, 0, 0],
                          dorientation=[0, 0, 0, 0])
           for T, k in ((T1, H // 2 - 1), (T2, H - 1))]
    return make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, H, 2,
                     dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax,
                     dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10,
                     dtype=np.float64)


def _jax_cons(rows, b):
    """JAX Constraints with the given rows A [nc, n+m] at every step."""
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints

    return Constraints.uniform(np.asarray(rows, float), np.asarray(b, float), H)


def _rows(entries, width=14, nc=1):
    """An [nc, width] constraint matrix with the given (row, column, value)
    entries."""
    A = np.zeros((nc, width))
    for r, c, v in entries:
        A[r, c] = v
    return A


X5 = _rows([(0, 5, 1.0)])                # x5 <= b (the tutorial's bound)
X45 = _rows([(0, 4, 1.0), (0, 5, 1.0)])  # x4 + x5 <= b: does not fold


@pytest.fixture(scope="module")
def first():
    jspec = _jax_spec(1)
    return jspec, spec_like(jspec, device="cpu")


def _lanes(n, seed=3, scale=0.05):
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + scale * rng.normal(size=(B, 7))
    x0s = q0s if n == 7 else np.concatenate([q0s, np.zeros((B, 7))], axis=-1)
    return q0s, x0s, np.zeros((B, H - 1, 7))


def _close(got, ref, cost_rtol, u_atol, lam_atol):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=cost_rtol, atol=0)
    if u_atol is not None:
        np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U),
                                   atol=u_atol, rtol=0)
    np.testing.assert_allclose(got.multipliers.numpy(),
                               np.asarray(ref.multipliers), atol=lam_atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the per-step pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_cons", [False, True], ids=["shared", "per_lane"])
def test_active_sets_match_jax(first, lane_cons):
    """Penalty-scaled active sets and violations on seeded trajectories,
    with some duals at zero (so both branches of the active set show)."""
    from ilqr_planner_tpu.solvers import al_ilqr as jal

    rng = np.random.default_rng(0)
    X = rng.normal(size=(H, 7))
    U = rng.normal(size=(H - 1, 7))
    A = rng.normal(size=(H - 1, 3, 14)) if lane_cons else np.broadcast_to(
        rng.normal(size=(3, 14)), (H - 1, 3, 14))
    b = rng.normal(size=(H - 1, 3))
    lam = np.where(rng.random((H - 1, 3)) < 0.5, 0.0, rng.random((H - 1, 3)))
    ref = jal._active_sets(jal.Constraints(A=A, b=b), lam, 0.3, X, U)
    A_t = torch.as_tensor(np.ascontiguousarray(A))
    cons = al_ilqr.Constraints(A=A_t[None] if lane_cons else A_t,
                               b=torch.as_tensor(b))
    got = al_ilqr._active_sets(cons, torch.as_tensor(lam)[None], 0.3,
                               torch.as_tensor(X)[None], torch.as_tensor(U)[None])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=1e-12, rtol=0)


@pytest.mark.parametrize("nb_deriv", [1, 2])
def test_backward_core_al_matches_jax(nb_deriv):
    """The AL backward pass on seeded stage terms: the first-order diagonal
    shortcut and the double integrator's constant A, B; the constraint
    rows dense, so every term of every Q block carries them. Gains within
    1e-12 of the largest gain: the products sum in another order, and the
    double integrator's elimination amplifies that by up to ~10x (ROADMAP
    Queue 3, F2)."""
    from ilqr_planner_tpu.solvers import al_ilqr as jal

    jspec = _jax_spec(nb_deriv)
    spec = spec_like(jspec, device="cpu")
    n, m, nc, hm1 = spec.nx, spec.nu, 3, 12
    rng = np.random.default_rng(1)

    def spd(*lead):
        M = rng.normal(size=lead + (n, n))
        return M @ np.swapaxes(M, -1, -2) + n * np.eye(n)

    ins = dict(l_x=rng.normal(size=(hm1, n)), l_u=rng.normal(size=(hm1, m)),
               l_xx=spd(hm1), lN_x=rng.normal(size=n), lN_xx=spd(),
               ckx=0.3 * rng.normal(size=(hm1, nc, n)),
               cku=0.3 * rng.normal(size=(hm1, nc, m)),
               Is=rng.choice([0.0, 0.25], size=(hm1, nc)),
               Cs=rng.normal(size=(hm1, nc)), lam=rng.random((hm1, nc)))
    Ks_r, ds_r = jal._backward_core_al(jspec, (), (), *ins.values())
    t = {k: torch.as_tensor(v)[None] for k, v in ins.items()}
    Ks, ds = al_ilqr._backward_core_al(spec, (), (), *t.values())
    for got, ref in ((Ks[0], Ks_r), (ds[0], ds_r)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the recursive solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb_iter, cost_rtol, u_atol, lam_atol",
                         [(6, 1e-9, 1e-8, 1e-10), (12, 1e-6, None, 1e-8)])
def test_solve_record_matches_jax(first, nb_iter, cost_rtol, u_atol, lam_atol):
    """al_ilqr.solve(record=True) under the bound x5 <= 1.5: 6 iterations,
    and 12 with two dual updates; the record at each iteration."""
    from ilqr_planner_tpu.solvers import al_ilqr as jal

    jspec, spec = first
    jcons = _jax_cons(X5, [1.5])
    U0 = np.zeros((H - 1, 7))
    ref = jal.solve(jspec, jcons, np.zeros(1), U0, nb_iter, *AL_ARGS,
                    early_stop=False, record=True)
    got = al_ilqr.solve(spec, constraints_like(jcons, device="cpu"),
                        np.zeros(1), U0, nb_iter, *AL_ARGS, early_stop=False,
                        record=True)
    _close(got, ref, cost_rtol, u_atol, lam_atol)
    assert int(got.iterations) == int(ref.iterations) == nb_iter
    assert float(got.multipliers.max()) > 0      # the bound is live
    for k in ("cost", "alpha"):
        np.testing.assert_allclose(got.progress[k].numpy(),
                                   np.asarray(ref.progress[k]), rtol=cost_rtol)


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard"])
def test_hooks_match_jax(first, guard):
    """callback= and guard= of the AL solver against the JAX package's (its
    while-loop body, which a callback selects): the messages string-equal,
    delivered on the caller's thread, one an outer iteration (the plain
    cost); the result equals the port's solve without a callback bit for
    bit and the JAX one at the 6-iteration tolerances. The line search
    floors out at iteration 6: unguarded, the solve adopts the floor
    trial's higher cost (0.018672); guarded, it keeps the incumbent's
    (0.0186695) and stops."""
    import threading

    from ilqr_planner_tpu.solvers import al_ilqr as jal

    jspec, spec = first
    cons = al_ilqr.Constraints.uniform(X5, [1.5], H, device="cpu")
    U0 = np.zeros((H - 1, 7))
    heard, threads = [], set()

    class Heard:
        def notify(self, msg):
            heard.append(msg)
            threads.add(threading.get_ident())

    jheard = []
    want = jal.solve(jspec, _jax_cons(X5, [1.5]), np.zeros(1), U0, 12,
                     *AL_ARGS, guard=guard,
                     callback=types.SimpleNamespace(notify=jheard.append))
    got = al_ilqr.solve(spec, cons, np.zeros(1), U0, 12, *AL_ARGS,
                        guard=guard, callback=Heard())
    quiet = al_ilqr.solve(spec, cons, np.zeros(1), U0, 12, *AL_ARGS,
                          guard=guard)
    assert heard == jheard and threads == {threading.get_ident()}
    assert len(heard) == int(got.iterations) == int(want.iterations)
    for f in ("X", "U", "multipliers", "cost", "iterations"):
        assert torch.equal(getattr(got, f), getattr(quiet, f)), f
    _close(got, want, 1e-9, 1e-8, 1e-10)
    last, before = (m.split("Cost: ")[1].split(",")[0] for m in heard[-1:-3:-1])
    assert heard[-1].endswith("alpha= 0.000976562")
    assert (last == before) == guard


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

FOLD_CASES = {
    "one_state_coordinate": (_rows([(0, 5, 1.0), (1, 2, -2.0)], nc=2), True),
    "zero_rows": (_rows([(5, 5, 1.0)], nc=14), True),
    "all_zero": (_rows([], nc=2), True),
    "control_row": (_rows([(0, 9, 1.0)]), True),
    "coupled_row": (X45, True),
    "not_uniform": (None, False),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_plan_matches_jax(first, case):
    """The fold plan (None, or (row, state coordinate, coefficient) per
    folding row) and the uniformity flag, as the JAX fleet computes them."""
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints as JCons
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver_al as jmake

    jspec, spec = first
    rows, uniform = FOLD_CASES[case]
    if uniform:
        jcons = _jax_cons(rows, np.full(rows.shape[0], 2.0))
    else:
        A = np.zeros((H - 1, 1, 14))
        A[:, 0, 5] = np.linspace(1.0, 2.0, H - 1)
        jcons = JCons(A=A, b=np.full((H - 1, 1), 2.0))
    ref = inspect.getclosurevars(
        jmake(jspec, jcons, 2, *AL_ARGS).inner).nonlocals["al_static"]
    got = fleet._al_plan(constraints_like(jcons, device="cpu"), spec.nx,
                         np.float64)
    assert got["fold"] == ref["fold"]
    assert got["uniform"] == ref["uniform"] and got["nc"] == ref["nc"]


@pytest.mark.parametrize("nb_deriv", [1, 2])
def test_folded_fleet_matches_jax_fleet(nb_deriv):
    """The tutorial's bound, folded into the stage rows: the port's fleet
    (the unconstrained kernels' twins) against the JAX fleet."""
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver_al as jmake

    jspec = _jax_spec(nb_deriv)
    spec = spec_like(jspec, device="cpu")
    A = X5 if nb_deriv == 1 else _rows([(0, 5, 1.0)], width=21)
    jcons = _jax_cons(A, [1.5])
    _, x0s, U0s = _lanes(spec.nx)
    ref = jmake(jspec, jcons, 6, *AL_ARGS, early_stop=False,
                backward="xla")(x0s, U0s, np.zeros(1))
    cons = constraints_like(jcons, device="cpu")
    assert fleet._al_plan(cons, spec.nx, np.float64)["fold"] == [(0, 5, 1.0)]
    got = fleet.make_fleet_solver_al(spec, cons, 6, *AL_ARGS,
                                     early_stop=False)(x0s, U0s, np.zeros(1))
    _close(got, ref, 1e-9, 1e-8, 1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


def test_nonfoldable_fleet_matches_jax_vmap(first):
    """x4 + x5 <= 2 does not fold: the fleet's generic sweep with the AL
    terms, and the recursive route, against the JAX vmap route."""
    from ilqr_planner_tpu.parallel import solve_batch_al as jsolve

    jspec, spec = first
    jcons = _jax_cons(X45, [2.0])
    cons = constraints_like(jcons, device="cpu")
    q0s, _, U0s = _lanes(7)
    ref = jsolve(jspec, jcons, np.zeros(1), {"q0": q0s, "x0": q0s}, U0s, 6,
                 *AL_ARGS, early_stop=False, prefer_fleet=False)
    assert fleet._al_plan(cons, spec.nx, np.float64)["fold"] is None
    solver = fleet.make_fleet_solver_al(spec, cons, 6, *AL_ARGS, early_stop=False)
    _close(solver(q0s, U0s, np.zeros(1)), ref, 1e-9, 1e-8, 1e-10)
    rec = solve_batch_al(spec, cons, np.zeros(1), {"x0": q0s}, U0s, 6, *AL_ARGS,
                         early_stop=False, prefer_fleet=False)
    _close(rec, ref, 1e-9, 1e-8, 1e-10)


@pytest.fixture(scope="module")
def lane_duals(first):
    """The JAX fleet under the tutorial's bound (b = 1.5) from duals
    [B, H-1, 1] that are the same on every lane and step (0.02), 6
    iterations, early stop on."""
    from ilqr_planner_tpu.parallel import solve_batch_al as jsolve

    jspec, _ = first
    jcons = _jax_cons(X5, [1.5])
    q0s, _, U0s = _lanes(7, seed=4)
    lam3 = np.full((B, H - 1, 1), 0.02)
    ref = jsolve(jspec, jcons, lam3, {"x0": q0s}, U0s, 6, *AL_ARGS)
    return jcons, q0s, U0s, ref


@pytest.mark.parametrize("shape", ["nc", "H-1,nc", "B,H-1,nc"])
def test_solve_batch_al_lambda_shapes(first, lane_duals, shape):
    """solve_batch_al (the fleet) takes lam0 as [nc], [H-1, nc] or
    [B, H-1, nc]: the same duals in each shape give the JAX result."""
    _, spec = first
    jcons, q0s, U0s, ref = lane_duals
    lam0 = {"nc": np.full(1, 0.02), "H-1,nc": np.full((H - 1, 1), 0.02),
            "B,H-1,nc": np.full((B, H - 1, 1), 0.02)}[shape]
    got = solve_batch_al(spec, constraints_like(jcons, device="cpu"), lam0,
                         {"x0": q0s}, U0s, 6, *AL_ARGS)
    _close(got, ref, 1e-9, 1e-8, 1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


def test_solve_batch_al_batched_constraints(first):
    """Per-lane constraints (A [B, H-1, nc, n+m], a bound that differs by
    lane) and per-lane duals take the recursive route, against the JAX
    vmap route; the lanes with the same bound as the shared set give the
    fleet's result."""
    from ilqr_planner_tpu.parallel import solve_batch_al as jsolve
    from ilqr_planner_tpu.solvers.al_ilqr import Constraints as JCons

    jspec, spec = first
    bounds = np.array([1.5, 1.4, 1.5, 1.6])
    A = np.broadcast_to(X5, (B, H - 1, 1, 14)).copy()
    b = np.broadcast_to(bounds[:, None, None], (B, H - 1, 1)).copy()
    lam = np.random.default_rng(5).random((B, H - 1, 1)) * 0.05
    q0s, _, U0s = _lanes(7, seed=6)
    jcons = JCons(A=A, b=b)
    ref = jsolve(jspec, jcons, lam, {"q0": q0s, "x0": q0s}, U0s, 6, *AL_ARGS,
                 early_stop=False)
    cons = constraints_like(jcons, device="cpu")
    got = solve_batch_al(spec, cons, lam, {"x0": q0s}, U0s, 6, *AL_ARGS,
                         early_stop=False)
    _close(got, ref, 1e-9, 1e-8, 1e-10)
    shared = al_ilqr.Constraints.uniform(X5, [1.5], H, device="cpu")
    fl = solve_batch_al(spec, shared, lam, {"x0": q0s}, U0s, 6, *AL_ARGS,
                        early_stop=False)
    same = bounds == 1.5
    np.testing.assert_allclose(fl.cost.numpy()[same], got.cost.numpy()[same],
                               rtol=1e-9)


def test_solve_batch_al_staged_matches_plain_and_jax(first):
    """The staged schedule (first stage 3 of 8 iterations, buckets of 4)
    gives the plain solve's result, and the JAX package's staged one."""
    from ilqr_planner_tpu.parallel import solve_batch_al_staged as jstaged

    jspec, spec = first
    jcons = _jax_cons(X5, [1.5])
    cons = constraints_like(jcons, device="cpu")
    q0s, _, U0s = _lanes(7, seed=7)
    lam3 = np.random.default_rng(8).random((B, H - 1, 1)) * 0.05
    kw = dict(first_stage=3, bucket=4)
    ref = jstaged(jspec, jcons, lam3, {"x0": q0s}, U0s, 8, *AL_ARGS, **kw)
    got = solve_batch_al_staged(spec, cons, lam3, {"x0": q0s}, U0s, 8,
                                *AL_ARGS, **kw)
    plain = solve_batch_al(spec, cons, lam3, {"x0": q0s}, U0s, 8, *AL_ARGS)
    assert bool((plain.iterations >= 3).any())      # some lanes restaged
    np.testing.assert_array_equal(got.iterations.numpy(), plain.iterations.numpy())
    np.testing.assert_allclose(got.cost.numpy(), plain.cost.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.multipliers.numpy(), plain.multipliers.numpy(),
                               atol=1e-12)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    _close(got, ref, 1e-6, None, 1e-8)
