"""Port parity, the planar n-link robot: `models/planar.py`, its `Robot`
dispatch, `make_spec` on it, and the planar position-tracking solve on both
batch paths, against the JAX package in float64 on the CPU (where the
port's wrappers run the kernels' twins: segment_backward at n = 3 on the
fleet, riccati at (n, nq) = (3, 2) on the recursive route).

Tolerances: kinematics 1e-12 (the forward-difference Jacobian with step
pi * 1e-3, as the reference computes it); the riccati twin 1e-10 of the
JAX reference's largest gain; solves: iterations and alpha equal per lane,
cost rtol 1e-10, U and fX atol 1e-9.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import (PlanarRobot, Robot, planar_fk,
                                       planar_jacobian, planar_kin, robot_fk,
                                       robot_kin)
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers.fleet import fleet_supported, make_fleet_solver
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec
from ilqr_planner_torch.utils.convert import robot_from_arrays, spec_like

LENGTHS = np.array([0.5, 0.4, 0.3])
TOL = 1e-12


def _robots():
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models.planar import PlanarRobot as JPlanar

    return (JRobot.from_planar(JPlanar(lengths=np.asarray(LENGTHS))),
            robot_from_arrays("planar", lengths=LENGTHS, device="cpu"))


def test_planar_kinematics_match_jax():
    """planar_fk, the forward-difference Jacobian and the kinematic state
    (identity quaternion, zero rotational rows, dJ = 0) against the JAX
    package's, at random (q, dq); robot_fk is robot_kin's x and quat bit
    for bit."""
    import jax
    import jax.numpy as jnp

    from ilqr_planner_tpu.models import robot_kin as jrobot_kin
    from ilqr_planner_tpu.models import planar as jplanar

    jrobot, robot = _robots()
    rng = np.random.default_rng(2)
    q = rng.uniform(-3.0, 3.0, size=(20, 3))
    dq = rng.normal(size=(20, 3))
    qt, dqt = torch.as_tensor(q), torch.as_tensor(dq)
    jq, jdq = jnp.asarray(q), jnp.asarray(dq)
    fk = jax.jit(jax.vmap(lambda a: jplanar.planar_fk(jrobot.planar, a)))(jq)
    jac = jax.jit(jax.vmap(lambda a: jplanar.planar_jacobian(jrobot.planar, a)))(jq)
    np.testing.assert_allclose(planar_fk(robot.planar, qt).numpy(),
                               np.asarray(fk), atol=TOL, rtol=0)
    np.testing.assert_allclose(planar_jacobian(robot.planar, qt).numpy(),
                               np.asarray(jac), atol=TOL, rtol=0)
    ref = jax.jit(jax.vmap(lambda a, b: jrobot_kin(jrobot, a, b)))(jq, jdq)
    got = robot_kin(robot, qt, dqt)
    for name in ("x", "dx", "quat", "w", "J", "dJ"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL,
                                   rtol=0, err_msg=name)
    assert torch.equal(planar_kin(robot.planar, qt, dqt).J, got.J)
    x, quat = robot_fk(robot, qt)
    assert torch.equal(x, got.x) and torch.equal(quat, got.quat)
    assert robot.dof == 3 and robot.nb_car_dim == 2


def test_planar_with_frame_raises_early():
    """A frame on a planar robot fails when it is attached, with the JAX
    package's message (its tests/test_fleet.py:655)."""
    jrobot, robot = _robots()
    with pytest.raises(ValueError) as want:
        jrobot.with_frame(np.eye(4))
    with pytest.raises(ValueError, match="3-D") as got:
        robot.with_frame(np.eye(4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="3-D"):
        Robot.from_planar(PlanarRobot(torch.ones(2))).with_frame(np.eye(4))


def _specs(H):
    """The JAX package's planar point problem (its tests/test_fleet.py:169:
    keypoints at H/2 - 1 and H - 1, limits +-10 pi) and the port's, built
    by each package's make_spec."""
    from ilqr_planner_tpu.systems import keypoints as jkps
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot, robot = _robots()
    qmax = np.ones(3) * np.pi * 10
    out = []
    for mk, rob, mod, kw in ((jmake_spec, jrobot, jkps, {"dtype": np.float64}),
                             (make_spec, robot, kps_mod, {"device": "cpu"})):
        kps = [mod.PointKeypoint([0.6, 0.5], np.eye(2), H // 2 - 1),
               mod.PointKeypoint([0.2, 0.9], np.eye(2), H - 1)]
        out.append(mk("point", rob, kps, np.ones(3) * 1e-5, H, 1, dt=0.1,
                      q0=np.array([0.3, 0.2, 0.1]), q_max=qmax, q_min=-qmax,
                      **kw))
    return out


def test_make_spec_on_a_planar_robot_matches_jax():
    jspec, spec = _specs(20)
    assert spec.nt == jspec.nt == 2 and spec.nq_var == jspec.nq_var == 2
    for name in ("mu", "prec", "kp_mask", "Rt", "x0", "state_max", "limit_weight"):
        np.testing.assert_array_equal(getattr(spec, name).numpy(),
                                      np.asarray(getattr(jspec, name)),
                                      err_msg=name)
    like = spec_like(jspec, device="cpu")
    assert torch.equal(like.robot.planar.lengths, spec.robot.planar.lengths)


def test_planar_point_matches_jax_on_both_paths():
    """H = 50, B = 4, 4 iterations without early stop: the port's fleet
    (the lane-major planar walk with the column-wise forward difference)
    against the JAX fleet, and the recursive route (riccati twin at nq = 2)
    against the JAX vmap path. The forward-difference Jacobian (step
    pi * 1e-3) amplifies rounding: on this problem the JAX package's own two
    paths differ by 8.1e-11 in cost after 4 iterations and by up to 2.3e-9
    after 9 (its tests/test_fleet.py:169 holds them to rtol 1e-9), and the
    port's recursive route (an explicit Gauss-Jordan inverse where the JAX
    vmap path solves) lands 1.1e-10 from the JAX one, so the recursive route
    is held to that test's 1e-9, the fleet to 1e-10."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    H, B = 50, 4
    jspec, spec = _specs(H)
    assert fleet_supported(spec)
    rng = np.random.default_rng(7)
    q0s = np.array([0.3, 0.2, 0.1])[None] + 0.1 * rng.normal(size=(B, 3))
    U0s = np.zeros((B, H - 1, 3))
    ov = {"q0": q0s, "x0": q0s}
    for prefer, rtol in ((True, 1e-10), (False, 1e-9)):
        ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False,
                           prefer_fleet=prefer)
        got = solve_batch(spec, ov, U0s, 4, early_stop=False,
                          prefer_fleet=prefer)
        np.testing.assert_array_equal(got.iterations.numpy(),
                                      np.asarray(ref.iterations))
        np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   rtol=rtol, atol=0)
        for name in ("U", "fX"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-9, rtol=0, err_msg=name)
        if prefer:
            direct = make_fleet_solver(spec, 4, early_stop=False)(q0s, U0s)
            assert torch.equal(direct.cost, got.cost)


def test_riccati_twin_matches_jax_at_the_planar_width():
    """The riccati twin at (n, nq) = (3, 2), the planar point's width,
    against the JAX package's plain reference."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_reference as jref)

    rng = np.random.default_rng(13)
    B, H, n, nq = 4, 40, 3, 2
    args = (rng.normal(size=(B, H, nq, n)) * 0.3,
            rng.normal(size=(B, H, nq)) * 0.05,
            (rng.uniform(size=(B, H, n)) < 0.005).astype(float),
            rng.normal(size=(B, H, n)) * 0.01,
            rng.normal(size=(B, H - 1, n)) * 0.1,
            np.zeros((H, nq, nq)))
    args[5][[H // 2 - 1, H - 1]] = np.eye(nq)
    Rt = [1e-5] * n
    K_ref, d_ref = (np.asarray(a) for a in jref(
        *(jnp.asarray(a) for a in args), np.asarray(Rt), 0.1))
    K, d = ric.riccati_backward_reference(*(torch.as_tensor(a) for a in args),
                                          Rt, 0.1)
    assert np.abs(K.numpy() - K_ref).max() <= 1e-10 * np.abs(K_ref).max()
    assert np.abs(d.numpy() - d_ref).max() <= 1e-10 * np.abs(d_ref).max()
