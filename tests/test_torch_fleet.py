"""Port parity, the whole fleet solve: ilqr_planner_torch's
make_fleet_solver / solve_batch against ilqr_planner_tpu's
make_fleet_solver(backward='xla') on the same float64 batch (CPU, where
the port's backward runs the kernel's twin).

Tolerances: iterations and alpha equal per lane; cost rtol 1e-9 and U atol
1e-9 (sums in another order; the limit penalty's active set can flip on a
boundary lane and move the final iterate by more than 1e-12).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import (PANDA_URDF, PlanarRobot, Robot,
                                       chain_from_urdf)
from ilqr_planner_torch.parallel import mesh, solve_batch, solve_batch_staged
from ilqr_planner_torch.solvers.fleet import make_fleet_solver
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
H, B, NB_ITER = 20, 8, 6
PREC = np.diag([1, 1, 1, .1, .1, .1])
SPEC_LEAVES = ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
               "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
               "dq0")


def _keypoints(kind, mod):
    if kind == "posorn":
        return [mod.PosOrnKeypoint(*T1, PREC, 9), mod.PosOrnKeypoint(*T2, PREC, 19)]
    if kind == "point":
        return [mod.PointKeypoint(T1[0], np.eye(3), 9),
                mod.PointKeypoint(T2[0], np.eye(3), 19)]
    return [mod.AngularKeypoint(Q0 + 0.3, np.eye(7), 19)]


def _specs(kind):
    """The same problem for both packages: limits q0 +- 0.4 so the penalty
    is live."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.systems import keypoints as jkps_mod
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    kw = dict(dt=0.1, q0=Q0, q_max=Q0 + 0.4, q_min=Q0 - 0.4)
    jspec = jmake_spec(kind, jrobot, _keypoints(kind, jkps_mod),
                       np.ones(7) * 1e-5, H, 1, dtype=np.float64, **kw)
    spec = make_spec(kind, robot, _keypoints(kind, kps_mod), np.ones(7) * 1e-5,
                     H, 1, device="cpu", **kw)
    return jspec, spec


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return Q0[None] + 0.05 * rng.normal(size=(B, 7)), np.zeros((B, H - 1, 7))


def _assert_matches(got, ref):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9, atol=0)
    for name in ("U", "X", "fX"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-9,
                                   rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def posorn_case():
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    jspec, spec = _specs("posorn")
    q0s, U0s = _batch()
    ref = jmake(jspec, NB_ITER, backward="xla")(q0s, U0s)
    return jspec, spec, q0s, U0s, ref


def test_spec_leaves_equal_jax():
    jspec, spec = _specs("posorn")
    for k in ("kind", "nb_deriv", "horizon", "limits_set"):
        assert getattr(spec, k) == getattr(jspec, k), k
    for k in SPEC_LEAVES:
        ref = np.asarray(getattr(jspec, k))
        got = getattr(spec, k).numpy()
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


def test_fleet_solve_matches_jax_posorn(posorn_case):
    _, spec, q0s, U0s, ref = posorn_case
    got = make_fleet_solver(spec, NB_ITER)(q0s, U0s)
    _assert_matches(got, ref)
    np.testing.assert_allclose(got.ds.numpy(), np.asarray(ref.ds), atol=1e-9,
                               rtol=0)
    assert got.X.shape == (B, H, 7) and got.fX.shape == (B, H, 7)
    assert got.Ks.shape == (B, H - 1, 7, 7) and got.iterations.dtype == torch.int32


def test_solve_batch_matches_fleet_and_jax(posorn_case):
    _, spec, q0s, U0s, ref = posorn_case
    got = solve_batch(spec, {"q0": q0s, "x0": q0s}, U0s, NB_ITER)
    direct = make_fleet_solver(spec, NB_ITER)(q0s, U0s)
    assert torch.equal(got.cost, direct.cost) and torch.equal(got.U, direct.U)
    _assert_matches(got, ref)
    again = solve_batch(spec, {"x0": q0s}, U0s, NB_ITER)
    assert torch.equal(again.cost, got.cost)
    assert len(mesh._fleet_cache) >= 1


@pytest.mark.parametrize("kind", ["joint", "point"])
def test_fleet_solve_matches_jax_other_kinds(kind):
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    jspec, spec = _specs(kind)
    q0s, U0s = _batch(seed=1)
    ref = jmake(jspec, NB_ITER, backward="xla")(q0s, U0s)
    _assert_matches(make_fleet_solver(spec, NB_ITER)(q0s, U0s), ref)


def test_fleet_cache_is_lru_bounded(monkeypatch):
    _, spec = _specs("joint")
    monkeypatch.setattr(mesh, "_FLEET_CACHE_MAX", 2)
    monkeypatch.setattr(mesh, "_fleet_cache", type(mesh._fleet_cache)())
    U0s = np.zeros((2, H - 1, 7))
    for nb_iter in (1, 2, 3, 1):
        solve_batch(spec, {}, U0s, nb_iter)
    assert [k[1] for k in mesh._fleet_cache] == [3, 1]


def test_mat_to_quat_soa_matches_so3():
    """The lane-major Shepperd extraction against ops.so3.mat_to_quat on
    random rotations and on the half turns and identity, where the selected
    candidate changes; float64, 1e-12 (the scores sum in another order)."""
    from ilqr_planner_torch.ops import so3
    from ilqr_planner_torch.solvers.fleet import _mat_to_quat_soa

    rng = np.random.default_rng(3)
    quats = rng.normal(size=(64, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    R = so3.quat_to_mat(torch.as_tensor(quats))
    edges = torch.stack([torch.eye(3, dtype=torch.float64),
                         torch.diag(torch.tensor([1.0, -1.0, -1.0])).double(),
                         torch.diag(torch.tensor([-1.0, 1.0, -1.0])).double(),
                         torch.diag(torch.tensor([-1.0, -1.0, 1.0])).double()])
    R = torch.cat([R, edges])
    got = _mat_to_quat_soa(R.permute(1, 2, 0))
    np.testing.assert_allclose(got.T.numpy(), so3.mat_to_quat(R).numpy(),
                               atol=1e-12, rtol=0)


def test_make_spec_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_spec(device=None) succeeds")
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spec("joint", robot, _keypoints("joint", kps_mod),
                  np.ones(7) * 1e-5, H, 1, dt=0.1, q0=Q0)


def test_out_of_scope_raises_not_implemented():
    from ilqr_planner_torch.solvers import al_ilqr, ilqr
    from ilqr_planner_torch.solvers.fleet import fleet_supported

    _, spec = _specs("joint")
    robot = spec.robot
    U0 = np.zeros((H - 1, 7))
    # the parallel-scan backward solves, and the AL solver's guard /
    # callback hooks work: one message an outer iteration, the plain cost
    assert torch.isfinite(ilqr.solve(spec, U0, 2, backward="pscan").cost)
    cons = al_ilqr.Constraints.uniform(np.zeros((1, 14)), np.zeros(1), H,
                                       device="cpu")
    al_args = (cons, np.zeros(1), U0, 2, 1, 0.25, 1.1)
    plain = al_ilqr.solve(spec, *al_args)
    heard = []
    cb = types.SimpleNamespace(notify=heard.append)
    hooked = al_ilqr.solve(spec, *al_args, callback=cb)
    assert [m.split(",")[0] for m in heard] == [
        f"Iteration {i + 1}" for i in range(int(plain.iterations))]
    assert torch.equal(hooked.U, plain.U)
    guarded = al_ilqr.solve(spec, *al_args, guard=True)
    assert float(guarded.cost) <= float(plain.cost) * (1 + 1e-12)
    with pytest.raises(ValueError, match="nb_deriv must be 1 or 2"):
        make_spec("joint", robot, [], np.ones(7) * 1e-5, H, 3, dt=0.1,
                  device="cpu")
    with pytest.raises(ValueError, match="unknown system kind"):
        make_spec("sequential", robot, [], np.ones(7) * 1e-5, H, 1, dt=0.1,
                  device="cpu")
    # the time-optimal double integrator (item 3) is in: make_spec and the
    # fleet take it
    spec_t2 = make_spec("posorn_time", robot, [], np.ones(8) * 1e-5, H, 2,
                        device="cpu")
    assert spec_t2.nx == 15 and fleet_supported(spec_t2)
    make_fleet_solver(spec_t2, 2)
    # what the fleet still does not take: a leaf outside FLEET_OVERRIDES, a
    # posorn target on a planar robot; the staged schedule does not record
    with pytest.raises(ValueError, match="unsupported fleet overrides"):
        make_fleet_solver(spec, 2, overrides=("dt",))
    planar = Robot.from_planar(PlanarRobot(torch.ones(3, dtype=torch.float64)))
    with pytest.raises(ValueError, match="fleet scope"):
        make_fleet_solver(dataclasses.replace(spec, kind="posorn",
                                              robot=planar), 2)
    U0s = np.zeros((2, H - 1, 7))
    # a per-lane dt is not a fleet leaf: solve_batch takes the recursive
    # route, each lane the single solve of its own dt
    dts = np.array([float(spec.dt), 0.05])
    lanes = solve_batch(spec, {"dt": dts}, U0s, 2)
    for i, dt in enumerate(dts):
        one = ilqr.solve(dataclasses.replace(
            spec, dt=torch.tensor(dt, dtype=torch.float64)), U0s[i], 2)
        np.testing.assert_allclose(lanes.cost[i].item(), one.cost.item(),
                                   rtol=1e-10)
    with pytest.raises(ValueError, match="record=True"):
        solve_batch_staged(spec, {}, U0s, 2, record=True)
