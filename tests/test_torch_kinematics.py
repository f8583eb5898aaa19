"""Port parity, kinematics: ilqr_planner_torch so3 / URDF / chain against
ilqr_planner_tpu on the same float64 inputs (CPU).

Tolerance 1e-12: both sides run the same float64 formulas; only the order
of a few 3-term sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import (PANDA_URDF, Robot, chain_fk,
                                       chain_from_urdf, chain_jacobian,
                                       chain_kin, parse_urdf)
from ilqr_planner_torch.ops import so3
from ilqr_planner_torch.solvers import fleet
from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
from ilqr_planner_torch.systems.spec import make_spec
from ilqr_planner_torch.utils.convert import chain_from_arrays
from ilqr_planner_tpu.models import chain as jchain_mod
from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
from ilqr_planner_tpu.ops import so3 as jso3

TOL = 1e-12
CHAIN_FIELDS = ("origin_rot", "origin_pos", "axis", "prismatic", "tip_rot",
                "tip_pos")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_chain():
    return jchain_from_urdf(PANDA_URDF.read_text(), "panda_link0", "panda_tip",
                            is_path=False, dtype=np.float64,
                            prefer_native=False)


@pytest.fixture(scope="module")
def chain():
    return chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip",
                           device="cpu")


def _edge_rotations():
    """Rotations where the Shepperd candidates tie or the trace is -1."""
    Rs = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
          np.diag([-1.0, -1.0, 1.0])]
    ax = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    for th in (np.pi, np.pi - 1e-9, 1e-9, 2 * np.pi / 3):
        Rs.append(np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    return np.stack(Rs)


def test_mat_to_quat_random_and_edge():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Rs = np.concatenate([np.asarray(jso3.quat_to_mat(jnp.asarray(q))),
                         _edge_rotations()])
    ref = np.asarray(jso3.mat_to_quat(jnp.asarray(Rs)))
    got = so3.mat_to_quat(_t(Rs)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_quat_to_mat_random_and_zero():
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.normal(size=(32, 4)), np.zeros((1, 4)),
                        [[1.0, 0, 0, 0], [0, 0, 0, -1.0]]])
    ref = np.asarray(jso3.quat_to_mat(jnp.asarray(q)))
    np.testing.assert_allclose(so3.quat_to_mat(_t(q)).numpy(), ref, atol=TOL,
                               rtol=0)


def test_axis_angle_random_and_zero_angle():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = np.concatenate([rng.uniform(-np.pi, np.pi, 28),
                            [0.0, np.pi, -np.pi, 2 * np.pi]])
    ref = np.asarray(jso3.axis_angle(jnp.asarray(axis), jnp.asarray(theta)))
    got = so3.axis_angle(_t(axis), _t(theta)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_urdf_chain_arrays_equal_jax(jax_chain, chain):
    for name in CHAIN_FIELDS:
        np.testing.assert_array_equal(getattr(chain, name).numpy(),
                                      np.asarray(getattr(jax_chain, name)),
                                      err_msg=name)


def test_urdf_text_and_unknown_frame(chain):
    text = chain_from_urdf(PANDA_URDF.read_text(), "panda_link0", "panda_tip",
                           is_path=False, device="cpu")
    for name in CHAIN_FIELDS:
        assert torch.equal(getattr(text, name), getattr(chain, name))
    assert [j["type"] for j in parse_urdf(str(PANDA_URDF), "panda_link0",
                                          "panda_tip")].count("revolute") == 7
    with pytest.raises(ValueError, match="Unable to build kinematic chain"):
        parse_urdf(str(PANDA_URDF), "panda_link0", "no_such_link")


def test_panda_home_pose(chain):
    """At q = 0 the tip lies in the x-z plane at the height the z offsets
    give: 0.333 + 0.316 + 0.384 - 0.107 - 0.1034 (the flange points down)."""
    p, _ = chain_fk(chain, torch.zeros(7, dtype=torch.float64))
    assert abs(float(p[1])) < 1e-12
    assert abs(float(p[0]) - 0.088) < 1e-12
    assert abs(float(p[2]) - (0.333 + 0.316 + 0.384 - 0.107 - 0.1034)) < 1e-12


def test_fk_and_jacobian_match_jax(jax_chain):
    chain = chain_from_arrays(*(np.asarray(getattr(jax_chain, f))
                                for f in CHAIN_FIELDS), device="cpu")
    rng = np.random.default_rng(3)
    q = rng.uniform(-2.8, 2.8, size=(16, 7))
    jac = jax.jit(jax.vmap(lambda qq: jchain_mod.chain_jacobian(jax_chain, qq)))
    p_ref, R_ref, J_ref = (np.asarray(a) for a in jac(jnp.asarray(q)))
    p, R, J = chain_jacobian(chain, _t(q))
    np.testing.assert_allclose(p.numpy(), p_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(R.numpy(), R_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(J.numpy(), J_ref, atol=TOL, rtol=0)
    _, quat = chain_fk(chain, _t(q))
    quat_ref = np.asarray(jso3.mat_to_quat(jnp.asarray(R_ref)))
    np.testing.assert_allclose(quat.numpy(), quat_ref, atol=TOL, rtol=0)
    dq = rng.normal(size=(16, 7))
    ks = chain_kin(chain, _t(q), _t(dq))
    np.testing.assert_allclose(ks.dx.numpy(), np.einsum("bij,bj->bi",
                                                        J_ref[:, :3], dq),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(ks.w.numpy(), np.einsum("bij,bj->bi",
                                                       J_ref[:, 3:], dq),
                               atol=TOL, rtol=0)
    kin = jax.jit(jax.vmap(lambda qq, vv: jchain_mod.chain_kin(jax_chain, qq, vv)))
    np.testing.assert_allclose(ks.dJ.numpy(),
                               np.asarray(kin(jnp.asarray(q), jnp.asarray(dq)).dJ),
                               atol=TOL, rtol=0)
    assert chain_kin(chain, _t(q), _t(dq), with_dJ=False).dJ is None


def test_fleet_lane_major_fk_matches_chain(chain):
    """The fleet's lane-major walk ([.., B] tensors) against the batch-leading
    chain functions of the port itself."""
    robot = Robot.from_chain(chain)
    kp = PosOrnKeypoint([0.5, 0.0, 0.4], [0.0, 1.0, 0.0, 0.0],
                        np.eye(6), 4)
    spec = make_spec("posorn", robot, [kp], np.ones(7) * 1e-5, 5, 1, dt=0.1,
                     device="cpu")
    cc = fleet._Consts(spec)
    rng = np.random.default_rng(4)
    q = _t(rng.uniform(-2.8, 2.8, size=(32, 7)))
    (d,) = fleet._fk_subs(cc, q.T.contiguous(), True)
    p, R, J = chain_jacobian(chain, q)
    np.testing.assert_allclose(d["p"].T.numpy(), p.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(d["J6"].permute(2, 0, 1).numpy(), J.numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(d["quat"].T.numpy(), so3.mat_to_quat(R).numpy(),
                               atol=TOL, rtol=0)


def test_robot_later_slices_raise(chain):
    """Frames and planar robots are ported; a frame on a planar robot and
    an unknown kind raise."""
    from ilqr_planner_torch.models import PlanarRobot, robot_kin

    robot = Robot.from_chain(chain)
    assert robot.dof == 7 and robot.nb_car_dim == 3
    assert robot.with_frame(np.eye(4)).frame.dtype == chain.origin_pos.dtype
    planar = Robot.from_planar(PlanarRobot(torch.ones(3, dtype=torch.float64)))
    assert planar.dof == 3 and planar.nb_car_dim == 2
    with pytest.raises(ValueError, match="3-D"):
        planar.with_frame(np.eye(4))
    q = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown robot kind"):
        robot_kin(Robot(kind="mesh", chain=chain), q, q)


def test_default_device_is_cuda():
    """With no device named the port goes to CUDA, and says so when there
    is no card instead of running on the CPU."""
    if torch.cuda.is_available():
        chain = chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip")
        assert chain.axis.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip")
