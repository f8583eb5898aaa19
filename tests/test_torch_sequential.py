"""Port parity, sequential specs and object frames: the port's
`transform_kin`, `jacobian_derivative`, `sequential_spec`, sequential
system functions, fleet and recursive solves against the JAX package's, in
float64 on the CPU (where the port's wrappers run the kernels' twins).

Tolerances: kinematics and system functions 1e-12; the riccati twin at the
sequential widths 1e-10 of the JAX reference's largest gain; solves:
iterations and alpha equal per lane, cost rtol 1e-10, U and fX atol 1e-9
(the JAX package's own fleet-vs-vmap tolerance, tests/test_fleet.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf, robot_kin
from ilqr_planner_torch.ops import so3
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers.fleet import fleet_supported, make_fleet_solver
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec, sequential_spec
from ilqr_planner_torch.utils.convert import spec_like

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
# the two object frames of the reference's multi-frame tutorial
OBJ_QUATS = ([0.63758403393523, 0.2994657314658187, 0.6042309402208079,
              -0.37244039285286973],
             [-0.03647984, 0.94060485, 0.33742794, 0.00860923])
OBJ_POS = ([0.62, 0.05, 0.34], [0.32, 0.05, 0.54])
QD = np.diag([1, 1, 1, 0, 0, 0])
CMD = np.ones(7) * 1e-5
QMAX = np.ones(7) * np.pi * 10
TOL = 1e-12


def frames():
    out = []
    for quat, pos in zip(OBJ_QUATS, OBJ_POS):
        T = np.eye(4)
        T[:3, :3] = so3.quat_to_mat(torch.tensor(quat, dtype=torch.float64)).numpy()
        T[:3, 3] = pos
        out.append(T)
    return out


def jax_robot():
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf

    return JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


def jax_two_frames(H, limits=True):
    """The JAX package's sequential spec over two object frames (its
    tests/test_fleet.py:381 problem), keypoints at H/2 and H-1."""
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec
    from ilqr_planner_tpu.systems.spec import sequential_spec as jseq

    robot = jax_robot()
    obj1, obj2 = frames()
    lim = dict(q_max=QMAX, q_min=-QMAX) if limits else {}
    sub1 = jmake_spec("posorn", robot.with_frame(obj1),
                      [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], QD, H // 2)],
                      CMD, H, 1, dt=0.01, q0=Q0, dtype=np.float64, **lim)
    sub2 = jmake_spec("posorn", robot.with_frame(obj2),
                      [PosOrnKeypoint([0.1, 0.1, -0.1], [1, 0, 0, 0], QD, H - 1)],
                      CMD, H, 1, dt=0.01, q0=Q0, dtype=np.float64, **lim)
    return jseq((sub1, sub2), CMD)


def jax_hybrid(H):
    """The JAX package's hybrid joint + position/orientation spec (its
    tests/test_fleet.py:462 problem)."""
    from ilqr_planner_tpu.systems.keypoints import AngularKeypoint, PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec
    from ilqr_planner_tpu.systems.spec import sequential_spec as jseq

    robot = jax_robot()
    sj = jmake_spec("joint", robot,
                    [AngularKeypoint(Q0 + 0.2, np.eye(7) * 0.1, H // 2)],
                    CMD, H, 1, dt=0.01, q0=Q0, q_max=QMAX, q_min=-QMAX,
                    dtype=np.float64)
    st = jmake_spec("posorn", robot,
                    [PosOrnKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1]), H - 1)],
                    CMD, H, 1, dt=0.01, q0=Q0, q_max=QMAX, q_min=-QMAX,
                    dtype=np.float64)
    return jseq((sj, st), CMD)


def assert_matches(got, ref, fX=True):
    """The port's result against the JAX package's: iterations and alpha
    equal per lane, cost rtol 1e-10, U (and fX) atol 1e-9."""
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    names = ("U", "fX") if fX else ("U",)
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-9,
                                   rtol=0, err_msg=name)


def test_transform_kin_and_jacobian_derivative_match_jax():
    """A framed chain's kinematic state (J', dJ', x', dx', w', q') and the
    Jacobian's time derivative, against the JAX package's vmapped
    chain_kin + transform_kin, at random (q, dq)."""
    import jax
    import jax.numpy as jnp

    from ilqr_planner_tpu.models import robot_kin as jrobot_kin

    T = frames()[0]
    jrobot = jax_robot().with_frame(T)
    robot = spec_like(jax_two_frames(10), device="cpu").subs[0].robot
    assert torch.equal(robot.frame, torch.as_tensor(T))
    rng = np.random.default_rng(3)
    q = rng.uniform(-2.8, 2.8, size=(12, 7))
    dq = rng.normal(size=(12, 7))
    ref = jax.jit(jax.vmap(lambda a, b: jrobot_kin(jrobot, a, b)))(
        jnp.asarray(q), jnp.asarray(dq))
    got = robot_kin(robot, torch.as_tensor(q), torch.as_tensor(dq))
    for name in ("x", "dx", "quat", "w", "J", "dJ"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL,
                                   rtol=0, err_msg=name)
    # the Jacobian-free forward map is the same, bit for bit
    from ilqr_planner_torch.models import robot_fk

    p, quat = robot_fk(robot, torch.as_tensor(q))
    assert torch.equal(p, got.x) and torch.equal(quat, got.quat)


def _pair(case):
    """(JAX sub-specs, port sub-specs) that differ from the first in one
    of the five ways `sequential_spec` refuses."""
    from ilqr_planner_tpu.systems.keypoints import AngularKeypoint as JKp
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot = jax_robot()
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    base = dict(kind="joint", Rt=CMD, H=20, nb=1, q0=Q0)
    other = dict(base, **{"nx": dict(nb=2), "nu": dict(Rt=np.ones(8)),
                          "horizon": dict(H=21), "x0": dict(q0=Q0 + 0.1),
                          "nb_deriv": {}}[case])
    out = []
    for mk, rob, Kp in ((jmake_spec, jrobot, JKp),
                        (make_spec, robot, kps_mod.AngularKeypoint)):
        specs = []
        for c in (base, other):
            kw = {} if mk is jmake_spec else {"device": "cpu"}
            specs.append(mk(c["kind"], rob, [], c["Rt"], c["H"], c["nb"],
                            dt=0.01, q0=c["q0"], **kw))
        if case == "nb_deriv":
            s = specs[1]
            specs[1] = (s.replace(nb_deriv=2) if mk is jmake_spec
                        else dataclasses.replace(s, nb_deriv=2))
        out.append(specs)
    return out


@pytest.mark.parametrize("case", ["nx", "nu", "horizon", "nb_deriv", "x0"])
def test_sequential_spec_errors_match_jax(case):
    from ilqr_planner_tpu.systems.spec import sequential_spec as jseq

    jsubs, subs = _pair(case)
    with pytest.raises(ValueError) as want:
        jseq(tuple(jsubs), CMD)
    with pytest.raises(ValueError) as got:
        sequential_spec(subs, CMD)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["two_frames", "hybrid"])
def test_sequential_funcs_match_jax(which):
    """fx_jac, residual, the block-diagonal precision, the summed limit and
    control costs, the stage and final costs, the gradients and the
    dynamics of a sequential spec, over a batch of states with the limits
    live, against the JAX package's functions vmapped."""
    import jax
    import jax.numpy as jnp

    from ilqr_planner_tpu.systems import funcs as jfuncs

    H = 12
    jspec = jax_two_frames(H) if which == "two_frames" else jax_hybrid(H)
    # limits Q0 +- 0.3 in every subsystem, so that the sums are live
    jspec = jspec.replace(subs=tuple(
        s.replace(state_max=jnp.asarray(Q0 + 0.3), state_min=jnp.asarray(Q0 - 0.3))
        for s in jspec.subs))
    spec = spec_like(jspec, device="cpu")
    rng = np.random.default_rng(5)
    x = Q0[None] + 0.4 * rng.normal(size=(16, 7))
    u = 0.1 * rng.normal(size=(16, 7))
    ks = np.arange(16) % H
    xt, ut, kt = torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(ks)

    def jv(fn):
        return jax.jit(jax.vmap(fn))(jnp.asarray(x), jnp.asarray(u),
                                     jnp.asarray(ks))

    fx_ref, J_ref = jv(lambda a, b, k: jfuncs.fx_jac(jspec, a))
    fx, J = funcs.fx_jac(spec, xt)
    np.testing.assert_allclose(fx.numpy(), np.asarray(fx_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), atol=TOL, rtol=0)
    assert torch.equal(funcs.fx(spec, xt), fx)
    checks = {
        "residual": (lambda a, b, k: jfuncs.residual(
            jspec, jfuncs.fx_jac(jspec, a)[0], k),
            lambda: funcs.residual(spec, fx, kt)),
        "prec": (lambda a, b, k: jfuncs.prec_at(jspec, k),
                 lambda: funcs.prec_at(spec, kt)),
        "stage_cost": (lambda a, b, k: jfuncs.stage_cost(
            jspec, a, jfuncs.fx_jac(jspec, a)[0], b, k),
            lambda: funcs.stage_cost(spec, xt, fx, ut, kt)),
        "final_cost": (lambda a, b, k: jfuncs.final_cost(
            jspec, a, jfuncs.fx_jac(jspec, a)[0]),
            lambda: funcs.final_cost(spec, xt, fx)),
        "gradients": (lambda a, b, k: jfuncs.cost_gradients(
            jspec, a, *jfuncs.fx_jac(jspec, a), b, k),
            lambda: funcs.cost_gradients(spec, xt, fx, J, ut, kt)),
        "dynamics": (lambda a, b, k: jfuncs.dynamics(jspec, a, b),
                     lambda: funcs.dynamics(spec, xt, ut)),
    }
    for name, (jfn, fn) in checks.items():
        ref, got = jv(jfn), fn()
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                       rtol=0, err_msg=name)
    assert spec.nt == jspec.nt and spec.nq_var == jspec.nq_var
    assert spec.nx == jspec.nx and spec.dof == jspec.dof


@pytest.mark.parametrize("nq", [12, 13])
def test_riccati_twin_matches_jax_at_sequential_widths(nq):
    """The riccati twin at the residual widths of two position +
    orientation subsystems (12) and of joint + position/orientation (13),
    block-diagonal precisions at two steps, against the JAX package's plain
    reference."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_reference as jref)

    rng = np.random.default_rng(nq)
    B, H, n = 3, 30, 7
    J = rng.normal(size=(B, H, nq, n)) * 0.3
    e = rng.normal(size=(B, H, nq)) * 0.05
    ld = (rng.uniform(size=(B, H, n)) < 0.005).astype(float)
    lq = ld * rng.normal(size=(B, H, n)) * 0.1
    u = rng.normal(size=(B, H - 1, n)) * 0.1
    prec = np.zeros((H, nq, nq))
    prec[[H // 2, H - 1]] = np.diag(rng.uniform(0.1, 1.0, size=nq))
    args = (J, e, ld, lq, u, prec)
    Rt = [1e-5] * n
    K_ref, d_ref = (np.asarray(a) for a in jref(
        *(jnp.asarray(a) for a in args), np.asarray(Rt), 0.01))
    K, d = ric.riccati_backward_reference(*(torch.as_tensor(a) for a in args),
                                          Rt, 0.01)
    assert np.abs(K.numpy() - K_ref).max() <= 1e-10 * np.abs(K_ref).max()
    assert np.abs(d.numpy() - d_ref).max() <= 1e-10 * np.abs(d_ref).max()


@pytest.fixture(scope="module")
def two_frames_case():
    """The two-frame problem, H = 60, B = 2, 4 iterations without early
    stop, through both JAX paths."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    H = 60
    jspec = jax_two_frames(H)
    rng = np.random.default_rng(4)
    q0s = Q0[None] + 0.05 * rng.normal(size=(2, 7))
    U0s = np.zeros((2, H - 1, 7))
    fleet = jmake(jspec, 4, early_stop=False, backward="xla")(q0s, U0s)
    vmap = jsolve_batch(jspec, {"q0": q0s, "x0": q0s}, U0s, 4,
                        early_stop=False, prefer_fleet=False)
    return jspec, q0s, U0s, fleet, vmap


def test_fleet_two_frames_matches_jax(two_frames_case):
    jspec, q0s, U0s, fleet, _ = two_frames_case
    spec = spec_like(jspec, device="cpu")
    assert fleet_supported(spec) and spec.kind == "sequential"
    got = make_fleet_solver(spec, 4, early_stop=False)(q0s, U0s)
    assert_matches(got, fleet)
    assert got.fX.shape == (2, 60, 14)


def test_recursive_two_frames_matches_jax(two_frames_case):
    """The recursive route: the riccati twin at nq = 12, both subsystems'
    limits folded into one diagonal (`ilqr._limit_diag`)."""
    jspec, q0s, U0s, _, vmap = two_frames_case
    spec = spec_like(jspec, device="cpu")
    got = solve_batch(spec, {"x0": q0s}, U0s, 4, early_stop=False,
                      prefer_fleet=False)
    assert_matches(got, vmap)


def test_hybrid_matches_jax_on_both_paths():
    """Joint + position/orientation subsystems (H = 50, B = 2): the fleet
    (the joint subsystem without FK) against the JAX fleet, the recursive
    route (riccati twin at nq = 13) against the JAX vmap path."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    H = 50
    jspec = jax_hybrid(H)
    spec = spec_like(jspec, device="cpu")
    assert spec.nq_var == 13
    rng = np.random.default_rng(8)
    q0s = Q0[None] + 0.05 * rng.normal(size=(2, 7))
    U0s = np.zeros((2, H - 1, 7))
    ov = {"q0": q0s, "x0": q0s}
    for prefer in (True, False):
        ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False,
                           prefer_fleet=prefer)
        got = solve_batch(spec, ov, U0s, 4, early_stop=False,
                          prefer_fleet=prefer)
        assert_matches(got, ref)


def test_sequential_list_overrides_match_jax():
    """Per-sub list overrides ([None, mu2]: the second subsystem's targets
    per lane, the first keeps its constants), on a frame and a frameless
    subsystem of one robot (one shared FK walk): both paths against the
    JAX package's (its tests/test_fleet.py:590 problem)."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec
    from ilqr_planner_tpu.systems.spec import sequential_spec as jseq

    H = 40
    robot = jax_robot()
    sub1 = jmake_spec("posorn", robot.with_frame(frames()[0]),
                      [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], QD, H // 2)],
                      CMD, H, 1, dt=0.01, q0=Q0, q_max=QMAX, q_min=-QMAX,
                      dtype=np.float64)
    sub2 = jmake_spec("posorn", robot, [PosOrnKeypoint(*T1, QD, H - 1)],
                      CMD, H, 1, dt=0.01, q0=Q0, q_max=QMAX, q_min=-QMAX,
                      dtype=np.float64)
    jspec = jseq((sub1, sub2), CMD)
    spec = spec_like(jspec, device="cpu")
    rng = np.random.default_rng(11)
    B = 3
    q0s = Q0[None] + 0.03 * rng.normal(size=(B, 7))
    U0s = np.zeros((B, H - 1, 7))
    mu2 = np.tile(np.asarray(sub2.mu)[None], (B, 1, 1))
    mu2[:, H - 1, :3] += 0.04 * rng.normal(size=(B, 3))
    ov = {"q0": q0s, "x0": q0s, "mu": [None, mu2]}
    for prefer in (True, False):
        ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False,
                           prefer_fleet=prefer)
        got = solve_batch(spec, ov, U0s, 4, early_stop=False,
                          prefer_fleet=prefer)
        assert_matches(got, ref)
    with pytest.raises(ValueError, match="one entry per subsystem"):
        solve_batch(spec, {"mu": [mu2]}, U0s, 2)
    with pytest.raises(ValueError, match="one entry per subsystem"):
        solve_batch(spec, {"mu": mu2}, U0s, 2)
