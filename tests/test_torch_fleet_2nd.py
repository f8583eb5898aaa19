"""Port parity for the fleet's double-integrator and time-optimal kinds:
make_spec leaves, the S^3 helpers of the velocity residual, and whole
solves through make_fleet_solver / solve_batch against the JAX package's
make_fleet_solver(backward='xla', rollout='xla') on the same float64 batch
(CPU, where the port's sweeps and rollouts run the kernels' twins).

Tolerances: spec leaves exact; S^3 helpers 1e-12 absolute (sums in
another order); solves: iterations and alpha equal per lane, cost rtol
1e-9, U/X/fX 1e-9 absolute (the reductions run in another order, and the
time-optimal trial cost is assembled after the rollout, not along it).
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers import fleet
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
H, B, NB_ITER = 16, 8, 6
SPEC_LEAVES = ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
               "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
               "dq0")
# (kind, nb_deriv) of this slice
CASES = (("posorn", 2), ("joint", 2), ("point", 2), ("posorn_time", 1),
         ("joint_time", 1))


def _keypoints(kind, nb, mod):
    z3, z4 = [0, 0, 0], [0, 0, 0, 0]
    if kind == "posorn":
        qd = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, .1, .1, .1])
        return [mod.PosOrnKeypoint(*T1, qd, 7, dposition=z3, dorientation=z4),
                mod.PosOrnKeypoint(*T2, qd, H - 1, dposition=z3, dorientation=z4)]
    if kind == "point":
        return [mod.PointKeypoint(T1[0], np.eye(6), 7, dposition=z3),
                mod.PointKeypoint(T2[0], np.eye(6), H - 1, dposition=z3)]
    if kind == "joint":
        return [mod.AngularKeypoint(Q0 - 0.2, np.eye(14), 7,
                                    dposition=np.zeros(7)),
                mod.AngularKeypoint(Q0 + 0.3, np.eye(14), H - 1,
                                    dposition=np.zeros(7))]
    if kind == "posorn_time":
        return [mod.SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), 7,
                                      2.0),
                mod.SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]),
                                      H - 1, 5.0)]
    return [mod.AngularTimeKeypoint(Q0 + 0.3, np.diag([1] * 7 + [.1]), H - 1,
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


def _batch(spec, seed=0):
    """(x0s [B, n], U0s [B, H-1, m]): q0 + 0.05 N(0, 1), zero velocity and
    time, zero controls with the time kinds' step control s = 0.1."""
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    x0s = np.concatenate([q0s, np.zeros((B, spec.nx - 7))], axis=-1)
    U0s = np.zeros((B, H - 1, spec.nu))
    if spec.time_optimal:
        U0s[..., -1] = 0.1
    return x0s, U0s


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


@pytest.mark.parametrize("kind,nb", CASES)
def test_spec_leaves_equal_jax(kind, nb):
    jspec, spec = _specs(kind, nb)
    for k in ("kind", "nb_deriv", "horizon", "limits_set"):
        assert getattr(spec, k) == getattr(jspec, k), k
    for k in SPEC_LEAVES:
        ref = np.asarray(getattr(jspec, k))
        got = getattr(spec, k).numpy()
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    assert fleet.fleet_supported(spec)


def _quats(rng, target):
    """Lane quaternions [4, L]: random unit ones, an all-zero lane, the
    target itself and its negation (distance 0 after the hemisphere flip)."""
    q = rng.normal(size=(4, 12))
    q /= np.linalg.norm(q, axis=0)
    t = np.asarray(target, float)[:, None]
    return np.concatenate([q, np.zeros((4, 1)), t, -t], axis=1)


@pytest.mark.parametrize("target", [T1[1], [0.0, 0.0, 0.0, 0.0]],
                         ids=["target", "zero_target"])
def test_quat_rate_and_transport_match_jax(target):
    import jax.numpy as jnp

    from ilqr_planner_tpu.solvers import fleet as jfleet

    rng = np.random.default_rng(4)
    quat = _quats(rng, T1[1])
    w = rng.normal(size=(3, quat.shape[1]))
    v = rng.normal(size=quat.shape)
    lanes = lambda a: [jnp.asarray(r) for r in a]  # noqa: E731

    ref = np.stack(jfleet._quat_rate(lanes(quat), lanes(w)))
    got = fleet._quat_rate(torch.as_tensor(quat), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)

    tq = np.asarray(target, float)
    nrm = np.linalg.norm(tq)
    const = (torch.as_tensor(tq)[:, None],
             torch.as_tensor(tq / (nrm if nrm > 0 else 1.0))[:, None],
             bool(np.all(tq == 0)))
    lq = fleet._q_lanes(torch.as_tensor(quat))
    vt = torch.as_tensor(v)
    cases = [(fleet._q_transport(vt, lq, fleet._q_lanes(torch.as_tensor(
        quat[:, ::-1].copy()))),
        jfleet._q_transport(lanes(v), lanes(quat), lanes(quat[:, ::-1])))]
    if const[2]:
        # an all-zero constant end point: v unchanged (the sd.h guard); the
        # JAX helper folds the distance to a Python float there and cannot
        # broadcast its guard (ROADMAP Queue 3)
        assert torch.equal(fleet._q_transport(vt, lq, const), vt)
        assert torch.equal(fleet._q_transport(vt, const, lq), vt)
    else:  # lanes -> constant, constant -> lanes
        cases += [
            (fleet._q_transport(vt, lq, const),
             jfleet._q_transport(lanes(v), lanes(quat), [float(x) for x in tq])),
            (fleet._q_transport(vt, const, lq),
             jfleet._q_transport(lanes(v), [float(x) for x in tq], lanes(quat)))]
    for got, ref in cases:
        ref = np.stack([np.broadcast_to(np.asarray(r), (quat.shape[1],))
                        for r in ref])
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind,nb", [c for c in CASES if c[0] != "point"])
def test_fleet_solve_matches_jax(kind, nb):
    """make_fleet_solver and solve_batch against the JAX fleet; on the CPU
    no kernel launches."""
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    jspec, spec = _specs(kind, nb)
    x0s, U0s = _batch(spec, seed=1)
    ref = jmake(jspec, NB_ITER, backward="xla", rollout="xla")(x0s, U0s)
    before = (dict(sb2.LAUNCHES), rt1.LAUNCHES)
    got = make_fleet_solver(spec, NB_ITER)(x0s, U0s)
    _assert_matches(got, ref)
    batched = solve_batch(spec, {"q0": x0s[:, :7], "x0": x0s}, U0s, NB_ITER)
    assert torch.equal(batched.cost, got.cost) and torch.equal(batched.U, got.U)
    assert (dict(sb2.LAUNCHES), rt1.LAUNCHES) == before
    assert got.X.shape == (B, H, spec.nx) and got.fX.shape == (B, H, spec.nt)
    assert got.Ks.shape == (B, H - 1, spec.nu, spec.nx)


def test_scan_line_search_matches_affine_on_2nd_order():
    """ls='scan' (one closed-loop rollout a trial) takes the same decisions
    as the affine family on an LTI kind."""
    _, spec = _specs("posorn", 2)
    x0s, U0s = _batch(spec, seed=2)
    aff = make_fleet_solver(spec, NB_ITER)(x0s, U0s)
    before = fleet.TRIALS
    scan = make_fleet_solver(spec, NB_ITER, ls="scan")(x0s, U0s)
    assert fleet.TRIALS > before
    np.testing.assert_array_equal(scan.iterations.numpy(), aff.iterations.numpy())
    np.testing.assert_array_equal(scan.alpha.numpy(), aff.alpha.numpy())
    np.testing.assert_allclose(scan.cost.numpy(), aff.cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(scan.U.numpy(), aff.U.numpy(), atol=1e-9, rtol=0)


def test_time_kind_rejects_affine_and_short_states():
    _, spec = _specs("posorn_time", 1)
    with pytest.raises(ValueError, match="ls='affine' requires LTI"):
        make_fleet_solver(spec, 2, ls="affine")
    x0s, U0s = _batch(spec)
    with pytest.raises(ValueError, match="8 columns"):
        solve_batch(spec, {"q0": x0s[:, :7]}, U0s, 2)
