"""Port parity, the recursive solver: `ilqr_planner_torch.solvers.ilqr.solve`
against `ilqr_planner_tpu.solvers.ilqr.solve` on the same float64 problem
(CPU, where the structured kinds' backward pass runs the riccati kernel's
twin), for posorn, joint and point at nb_deriv 1 (the riccati route) and
posorn at nb_deriv 2 and posorn_time at 1 (the generic route); and
`solve_batch(prefer_fleet=False)` against the JAX call and against the
port's own fleet path.

Tolerances: iterations and alpha equal; cost rtol 1e-9; X, U, fX, Ks and ds
1e-8 absolute (the explicit Gauss-Jordan inverse against the augmented
solve, sums in another order, carried through up to five iterations). The
double integrator's Quu = R + B'PB has B entries dt^2/2, so the unpivoted
elimination divides rounding by ~1e-5: its gains get 1e-6 absolute (entries
up to 117.7, measured 8.7e-8) and its X and U 1e-7 (U measured 2.0e-8 on
|U| <= 6.1). Recursive against fleet: cost rtol 1e-8.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
H, NB_ITER = 16, 5
# (kind, nb_deriv, backward route)
CASES = (("posorn", 1, "riccati"), ("joint", 1, "riccati"),
         ("point", 1, "riccati"), ("posorn", 2, "generic"),
         ("posorn_time", 1, "generic"))


def _keypoints(kind, nb, mod):
    z3, z4 = [0, 0, 0], [0, 0, 0, 0]
    if kind == "posorn":
        prec = np.diag([1, 1, 1, .1, .1, .1] * nb)
        vel = dict(dposition=z3, dorientation=z4) if nb == 2 else {}
        return [mod.PosOrnKeypoint(*T1, prec, 7, **vel),
                mod.PosOrnKeypoint(*T2, prec, H - 1, **vel)]
    if kind == "point":
        return [mod.PointKeypoint(T1[0], np.eye(3), 7),
                mod.PointKeypoint(T2[0], np.eye(3), H - 1)]
    if kind == "joint":
        return [mod.AngularKeypoint(Q0 - 0.2, np.eye(7), 7),
                mod.AngularKeypoint(Q0 + 0.3, np.eye(7), H - 1)]
    return [mod.SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), 7, 2.0),
            mod.SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]), H - 1,
                                  5.0)]


def _specs(kind, nb):
    """The same problem for both packages: joint limits q0 +- 0.4 so the
    penalty is live; joint velocity limits +-10 at nb_deriv 2."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.systems import keypoints as jkps_mod
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    time_kind = kind.endswith("_time")
    kw = dict(dt=None if time_kind else 0.1, q0=Q0, q_max=Q0 + 0.4,
              q_min=Q0 - 0.4)
    if nb == 2:
        kw.update(dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10)
    Rt = np.ones(8 if time_kind else 7) * 1e-5
    jspec = jmake_spec(kind, jrobot, _keypoints(kind, nb, jkps_mod), Rt, H, nb,
                       dtype=np.float64, **kw)
    spec = make_spec(kind, robot, _keypoints(kind, nb, kps_mod), Rt, H, nb,
                     device="cpu", **kw)
    return jspec, spec


def _U0(spec):
    U0 = np.zeros((H - 1, spec.nu))
    if spec.time_optimal:
        U0[:, -1] = 0.1
    return U0


def _assert_matches(got, ref, gains_atol=1e-8, traj_atol=1e-8):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9, atol=0)
    for name in ("X", "U", "fX", "Ks", "ds"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        atol = {"Ks": gains_atol, "ds": gains_atol, "X": traj_atol,
                "U": traj_atol}.get(name, 1e-8)
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind,nb,route", CASES)
def test_solve_matches_jax(kind, nb, route, monkeypatch):
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, spec = _specs(kind, nb)
    U0 = _U0(spec)
    ref = jilqr.solve(jspec, U0, NB_ITER)

    calls = []
    twin = ilqr.riccati_backward
    monkeypatch.setattr(ilqr, "riccati_backward",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    before = ric.LAUNCHES
    got = ilqr.solve(spec, U0, NB_ITER)
    assert ric.LAUNCHES == before               # the CPU launches no kernel
    # the route follows from the spec alone: one riccati call a backward pass
    assert len(calls) == (int(got.iterations) if route == "riccati" else 0)
    assert int(got.iterations) >= 2
    if nb == 2:
        _assert_matches(got, ref, gains_atol=1e-6, traj_atol=1e-7)
    else:
        _assert_matches(got, ref)
    assert got.X.shape == (H, spec.nx) and got.Ks.shape == (H - 1, spec.nu, spec.nx)
    assert got.iterations.dtype == torch.int32 and got.cost.dim() == 0
    # the solve improved on the initial rollout (zero gains from U0)
    assert float(got.cost) < float(ilqr.rollout(
        spec, 0.0, got.Ks * 0, got.ds * 0, got.X * 0,
        torch.as_tensor(U0))[6])


@pytest.mark.parametrize("opts", [dict(line_search=False),
                                  dict(early_stop=False),
                                  dict(line_search=False, early_stop=False)],
                         ids=["no_line_search", "no_early_stop", "neither"])
def test_solve_options_match_jax(opts):
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, spec = _specs("joint", 1)
    U0 = _U0(spec)
    ref = jilqr.solve(jspec, U0, NB_ITER, **opts)
    got = ilqr.solve(spec, U0, NB_ITER, **opts)
    _assert_matches(got, ref)
    if not opts.get("early_stop", True):
        assert int(got.iterations) == NB_ITER
    if not opts.get("line_search", True):
        assert float(got.alpha) == 1.0


def test_early_stop_freezes_a_converged_solve():
    """The joint kind converges at once: the solve stops before nb_iter, and
    more allowed iterations change nothing."""
    _, spec = _specs("joint", 1)
    U0 = _U0(spec)
    a = ilqr.solve(spec, U0, 12)
    b = ilqr.solve(spec, U0, 20)
    assert int(a.iterations) < 12
    for f in ("X", "U", "Ks", "ds", "cost", "iterations", "alpha"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_rollout_and_backward_match_jax():
    """`rollout` (all eight outputs) and `_backward` on the generic route
    against the JAX functions, on a time-optimal spec with per-step A, B."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, spec = _specs("posorn_time", 1)
    rng = np.random.default_rng(5)
    U0 = _U0(spec) + rng.normal(size=(H - 1, spec.nu)) * 0.02
    Ks = rng.normal(size=(H - 1, spec.nu, spec.nx)) * 0.05
    ds = rng.normal(size=(H - 1, spec.nu)) * 0.02
    Xref = np.tile(np.asarray(spec.x0), (H, 1)) + 0.01
    ref = jilqr.rollout(jspec, jnp.asarray(0.5), *(jnp.asarray(a) for a in
                                                   (Ks, ds, Xref, U0)))
    got = ilqr.rollout(spec, 0.5, *(torch.as_tensor(a) for a in
                                    (Ks, ds, Xref, U0)))
    for g, r, name in zip(got, ref, ("X", "fX", "U", "As", "Bs", "Js", "cost",
                                     "du")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12,
                                   rtol=0, err_msg=name)
    K_ref, d_ref = jilqr._backward(jspec, *ref[:6])
    K, d = ilqr._backward(spec, *(a[None] for a in got[:6]))
    np.testing.assert_allclose(K[0].numpy(), np.asarray(K_ref), atol=1e-9, rtol=0)
    np.testing.assert_allclose(d[0].numpy(), np.asarray(d_ref), atol=1e-9, rtol=0)
    assert ilqr.static_kp_steps(spec) == jilqr.static_kp_steps(jspec) == (7, H - 1)


def test_solve_batch_recursive_matches_jax_and_fleet():
    """prefer_fleet=False with a q0 override, B = 3: against the JAX call
    (whose vmap path reads the initial state from 'x0'), and against the
    port's fleet path on the same lanes; no warning on the explicit choice."""
    import warnings

    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec = _specs("posorn", 1)
    rng = np.random.default_rng(2)
    q0s = Q0[None] + 0.05 * rng.normal(size=(3, 7))
    U0s = np.zeros((3, H - 1, 7))
    ref = jsolve_batch(jspec, {"q0": q0s, "x0": q0s}, U0s, NB_ITER,
                       prefer_fleet=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = solve_batch(spec, {"q0": q0s}, U0s, NB_ITER, prefer_fleet=False)
    _assert_matches(got, ref)
    # with 'q0' alone the JAX vmap path still rolls out from the spec's x0
    lone = jsolve_batch(jspec, {"q0": q0s}, U0s, 1, prefer_fleet=False)
    np.testing.assert_array_equal(np.asarray(lone.X)[:, 0],
                                  np.tile(np.asarray(jspec.x0), (3, 1)))
    np.testing.assert_array_equal(got.X[:, 0].numpy(), q0s)
    assert got.X.shape == (3, H, 7) and got.cost.shape == (3,)
    assert len(set(got.cost.tolist())) == 3
    fleet = solve_batch(spec, {"q0": q0s}, U0s, NB_ITER)
    np.testing.assert_array_equal(got.iterations.numpy(), fleet.iterations.numpy())
    np.testing.assert_array_equal(got.alpha.numpy(), fleet.alpha.numpy())
    np.testing.assert_allclose(got.cost.numpy(), fleet.cost.numpy(), rtol=1e-8)
    np.testing.assert_allclose(got.U.numpy(), fleet.U.numpy(), atol=1e-8, rtol=0)
    # one lane of the batch is the single solve from that initial state
    one = ilqr.solve(dataclasses.replace(spec, x0=torch.as_tensor(q0s[1])),
                     U0s[1], NB_ITER)
    assert torch.equal(one.cost, got.cost[1]) and torch.equal(one.U, got.U[1])


def test_solve_batch_route_follows_the_spec_and_dispatch_errors_raise(monkeypatch):
    """A spec the fleet does not take goes to the recursive solver without a
    warning; an error in the fleet's dispatch propagates and is never
    answered by the recursive solver."""
    import warnings

    from ilqr_planner_torch.parallel import mesh

    _, spec = _specs("joint", 1)
    U0s = np.zeros((2, H - 1, 7))
    want = solve_batch(spec, {}, U0s, 3, prefer_fleet=False)
    monkeypatch.setattr(mesh, "fleet_supported", lambda s: False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet = solve_batch(spec, {}, U0s, 3)
    assert torch.equal(quiet.cost, want.cost)

    def boom(s):
        raise KeyError("broken dispatch")
    monkeypatch.setattr(mesh, "fleet_supported", boom)
    monkeypatch.setattr(ilqr, "_solve_impl", lambda *a: pytest.fail(
        "the recursive solver answered a failed fleet dispatch"))
    with pytest.raises(KeyError, match="broken dispatch"):
        solve_batch(spec, {}, U0s, 3)


def test_unported_arguments_raise():
    _, spec = _specs("joint", 1)
    U0 = _U0(spec)
    # the hooks are in: a callback hears each executed iteration, in order,
    # and leaves the solve as it was; the guard never ends above it
    heard = []
    cb = types.SimpleNamespace(notify=heard.append)
    res = ilqr.solve(spec, U0, 2, callback=cb)
    plain = ilqr.solve(spec, U0, 2)
    assert [m.split(",")[0] for m in heard] == [
        f"Iteration {i + 1}" for i in range(int(res.iterations))]
    assert heard[-1].split("Cost: ")[1].split(",")[0] == f"{float(plain.cost):g}"
    assert torch.equal(res.U, plain.U) and torch.equal(res.cost, plain.cost)
    guarded = ilqr.solve(spec, U0, 2, guard=True)
    assert bool(torch.isfinite(guarded.cost))
    assert float(guarded.cost) <= float(plain.cost) * (1 + 1e-12)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ilqr.solve(spec, U0, 2, record=True, callback=object())
    with pytest.raises(ValueError, match="'scan' or 'pscan'"):
        ilqr.solve(spec, U0, 2, backward="tree")
    with pytest.raises(ValueError, match="U0 must be"):
        ilqr.solve(spec, U0[:-1], 2)
    # a per-lane Rt is solved: the lane is the single solve of its Rt
    Rt = np.full((1, 7), 1e-3)
    lane = solve_batch(spec, {"Rt": Rt}, U0[None], 2, prefer_fleet=False)
    one = ilqr.solve(dataclasses.replace(spec, Rt=torch.as_tensor(Rt[0])), U0, 2)
    np.testing.assert_allclose(lane.cost[0].item(), one.cost.item(), rtol=1e-10)
    with pytest.raises(ValueError, match="U0s must be"):
        solve_batch(spec, {}, U0, 2, prefer_fleet=False)
