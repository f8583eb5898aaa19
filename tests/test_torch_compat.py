"""Port parity, the PyLQR drop-in API: `ilqr_planner_torch.compat` against
the JAX package's (`PyLQR`, its alias), float64 on the CPU, both built from
the same constructor arguments (the in-repo Panda URDF as text,
`is_path=False`; the port's robots with `device="cpu"`).

Gates: the callback messages string-equal; X and U at 1e-9 and the cost
at rtol 1e-9 (`ILQRRecursive`, `BatchILQR`, `BatchILQRCP`; `AL_ILQR` at the
6-iteration tolerances of `tests/test_torch_al.py`: cost rtol 1e-9, U
1e-8); the POS_ORN_SYS notebook's stored costs at rtol 2e-4; the replay
loop, every `System` accessor (`SequentialSystem`'s stacked mu and Q too),
`Robot2D.fkine`, `TransformedSimulationInterface`, `Sd` and `primitives`
at 1e-12.
"""

import threading
import types

import numpy as np
import pytest
import torch

import ilqr_planner_torch.compat as tcompat
from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.utils import MetricsCallback

URDF = PANDA_URDF.read_text()
DOF, H, DT = 7, 100, 0.1
Q0 = [0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
      1.50592777, 0.71771416]
T1 = (np.array([0.554121212377707, -0.01575049935289518, 0.38295604872511507]),
      np.array([0.014042440828406944, 0.915047647731553, 0.4024820607528928,
                0.022333898196169735]))
T2 = (np.array([0.254121212377707, -0.07575049935289518, 0.13170744424127526]),
      np.array([0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
                0.00011933313484481926]))
QMAX = np.array([np.pi] * DOF) * 10
# POS_ORN_SYS.ipynb's stored output (cell 12), ILQRRecursive's 8 iterations
GOLDEN = [0.214194, 0.0531093, 0.00372911, 0.000499702, 3.5657e-06,
          9.81748e-07, 9.80374e-07, 9.80376e-07]


def _frame(quat, pos):
    w, x, y, z = quat
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = pos
    return T


# the MULTI_SYS notebook's object frames (cell 8)
OBJ1 = _frame([0.63758403393523, 0.2994657314658187, 0.6042309402208079,
               -0.37244039285286973], [0.62, 0.05, 0.34])
OBJ2 = _frame([-0.03647984, 0.94060485, 0.33742794, 0.00860923],
              [0.32, 0.05, 0.54])


class Recorder:
    def __init__(self):
        self.messages = []

    def notify(self, msg):
        self.messages.append(msg)


def _pkg(name):
    """(the compat package, its robots' extra keyword arguments)."""
    if name == "jax":
        import PyLQR

        return PyLQR, {}
    return tcompat, {"device": "cpu"}


def _tutorial(name, horizon=H, dt=DT):
    """POS_ORN_SYS.ipynb cells 2-12 (at `horizon`, `dt`): the robot and
    the system."""
    pkg, kw = _pkg(name)
    rbt = pkg.sim.KDLRobot(URDF, "panda_link0", "panda_tip", Q0, [0] * DOF,
                           is_path=False, **kw)
    qd = np.diag([1, 1, 1, .1, .1, .1])
    kps = [pkg.system.PosOrnKeypoint(*T1, qd, horizon // 2 - 1),
           pkg.system.PosOrnKeypoint(*T2, qd, horizon - 1)]
    sys_ = pkg.system.PosOrnPlannerSys(rbt, kps, [1e-5] * DOF, QMAX, -QMAX,
                                       horizon, 1, dt)
    return rbt, sys_


@pytest.fixture(scope="module")
def both():
    return {name: _tutorial(name) for name in ("jax", "torch")}


def test_recursive_solver_matches_pylqr(both):
    out = {}
    for name, (_, sys_) in both.items():
        cb = Recorder()
        res = _pkg(name)[0].solver.ILQRRecursive(sys_).solve(
            np.zeros((H - 1, DOF)), 10, True, True, cb)
        out[name] = (res, cb.messages)
    (jres, jmsg), (tres, tmsg) = out["jax"], out["torch"]
    assert tmsg == jmsg
    costs = [float(m.split("Cost: ")[1].split(",")[0]) for m in tmsg]
    np.testing.assert_allclose(costs, GOLDEN, rtol=2e-4)
    assert all(isinstance(a, np.ndarray) for a in tres[:5])
    assert isinstance(tres[5], float)
    assert tres[1].shape == (H, 7)
    for i, name in enumerate(("X", "fX", "U")):
        np.testing.assert_allclose(tres[i], np.asarray(jres[i]), atol=1e-9,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(tres[5], jres[5], rtol=1e-9)
    assert tres[5] == pytest.approx(GOLDEN[-1], rel=2e-4)


def test_guard_keeps_the_incumbent_on_the_tutorial(both):
    """The 8th iteration floors out (alpha = 2^-10): unguarded it adopts
    the higher 9.80376e-07, guarded it keeps 9.80374e-07; as in JAX."""
    out = {}
    for name, (_, sys_) in both.items():
        cb = Recorder()
        res = _pkg(name)[0].solver.ILQRRecursive(sys_).solve(
            np.zeros((H - 1, DOF)), 10, True, True, cb, guard=True)
        out[name] = (res, cb.messages)
    (jres, jmsg), (tres, tmsg) = out["jax"], out["torch"]
    assert tmsg == jmsg and len(tmsg) == 8
    assert tres[5] == pytest.approx(9.80374e-07, rel=2e-4)
    assert tres[5] <= 9.803762709809737e-07
    np.testing.assert_allclose(tres[2], np.asarray(jres[2]), atol=1e-9, rtol=0)
    np.testing.assert_allclose(tres[5], jres[5], rtol=1e-9)


@pytest.mark.parametrize("cp", [False, True], ids=["batch", "cp"])
def test_batch_solvers_match_pylqr(both, cp):
    out = {}
    for name, (_, sys_) in both.items():
        solver = _pkg(name)[0].solver
        cb = Recorder()
        if cp:
            psi = _pkg(name)[0].utils.primitives.build_psi_unitstep(H - 1, 2)
            planner = solver.BatchILQRCP(sys_, np.kron(psi, np.eye(DOF)))
        else:
            planner = solver.BatchILQR(sys_)
        out[name] = (planner.solve(10, np.zeros(DOF * (H - 1)), True, cb),
                     cb.messages)
    (ju, jmsg), (tu, tmsg) = out["jax"], out["torch"]
    assert tmsg == jmsg
    assert tmsg[0].startswith("Iteration 1, Cost: 0.506613, ")
    assert isinstance(tu, np.ndarray) and tu.shape == (DOF * (H - 1),)
    np.testing.assert_allclose(tu, np.asarray(ju), atol=1e-9, rtol=0)


def test_al_tutorial_matches_pylqr():
    """POS_ORN_SYS_AL_ILQR at H=100 (dt=0.01): the unconstrained recursive
    solve, then AL_ILQR with x5 <= 2 at every step (100 iterations,
    lag_update_step 5, penalty 0.25, scaling 1.1), against PyLQR; the
    tutorial's own check max x5 <= 2.01."""
    out = {}
    for name in ("jax", "torch"):
        pkg = _pkg(name)[0]
        _, sys_ = _tutorial(name, 100, 0.01)
        u0 = np.zeros((99, DOF))
        cb = Recorder()
        X1, _, U1, _, _, c1 = pkg.solver.ILQRRecursive(sys_).solve(
            u0, 10, True, True, cb)
        A, b = np.zeros((14, 14)), np.zeros(14)
        A[5, 5], b[5] = 1.0, 2.0
        cons = []
        for _ in range(99):
            c = pkg.solver.Constraint()
            c.A, c.b = A, b
            cons.append(c)
        al_cb = Recorder()
        X2, F2, U2 = pkg.solver.AL_ILQR(sys_, cons, [b] * 99).solve(
            u0, 100, 5, .25, 1.1, True, True, al_cb)
        out[name] = [np.asarray(a) for a in (X1, U1, X2, F2, U2)] + [
            c1, cb.messages, al_cb.messages]
    j, t = out["jax"], out["torch"]
    assert t[6] == j[6] and t[7] == j[7]
    np.testing.assert_allclose(t[5], j[5], rtol=1e-9)
    for i, atol in ((0, 1e-9), (1, 1e-9), (2, 1e-8), (3, 1e-8), (4, 1e-8)):
        np.testing.assert_allclose(t[i], j[i], atol=atol, rtol=0)
    assert t[0][:, 5].max() > 2.01          # the bound matters
    assert t[2][:, 5].max() <= 2.01


def test_replay_loop_matches_pylqr(both):
    """Cell 14: the CP controls replayed through send_vel (99 steps); the
    end-effector trajectory of the port's CPU mirror against PyLQR's at
    1e-12, and the via-points within test_compat.py's tolerances."""
    psi = np.kron(tcompat.utils.primitives.build_psi_unitstep(H - 1, 2),
                  np.eye(DOF))
    U = np.asarray(tcompat.solver.BatchILQRCP(both["torch"][1], psi).solve(
        10, np.zeros(DOF * (H - 1)), True)).reshape(H - 1, DOF)
    traj = {}
    for name, (rbt, _) in both.items():
        rbt.set_conf(Q0, [0] * DOF, True)
        F = [np.hstack((rbt.get_ee_pos(), rbt.get_ee_orn()))]
        for i in range(H - 1):
            rbt.send_vel(DT, U[i], True)
            F.append(np.hstack((rbt.get_ee_pos(), rbt.get_ee_orn())))
        traj[name] = np.array(F)
        assert rbt.get_time() == pytest.approx(DT * (H - 1))
    np.testing.assert_allclose(traj["torch"], traj["jax"], atol=1e-12, rtol=0)
    np.testing.assert_allclose(traj["torch"][H // 2 - 1, :3], T1[0], atol=2e-2)
    np.testing.assert_allclose(traj["torch"][H - 1, :3], T2[0], atol=5e-3)
    for rbt, _ in both.values():
        rbt.set_conf(Q0, [0] * DOF, True)


def _same(a, b, what):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what      # the port returns numpy
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12, rtol=0,
                                   err_msg=what)
    else:
        assert a == b, what


def _accessors(sys_, rng_seed=0):
    """Every System accessor on seeded states and controls."""
    rng = np.random.default_rng(rng_seed)
    nx, nu = sys_.get_nb_state_var(), sys_.get_nb_ctrl_var()
    x = sys_.get_init_state() + 0.1 * rng.normal(size=nx)
    u = 0.1 * rng.normal(size=nu)
    kp = sys_.get_kp_indexes()
    out = {m: getattr(sys_, m)() for m in (
        "get_nb_state_var", "get_nb_ctrl_var", "get_nb_target_var",
        "get_nb_Q_var", "get_horizon", "get_nb_deriv", "get_kp_indexes",
        "get_init_state", "get_init_fx_state", "get_state")}
    out["get_fx_jac"] = sys_.get_fx_jac(x)
    out["forward_pass"] = sys_.forward_pass(x, u, 3)
    out["state_after_forward_pass"] = sys_.get_state()
    sys_.reset()
    out["forward_pass_batch"] = sys_.forward_pass_batch(
        0.05 * rng.normal(size=(sys_.get_horizon() - 1) * nu))
    fx, _ = sys_.get_fx_jac(x)
    out["diff"] = [sys_.diff(fx, k) for k in kp]
    out["diff_batch"] = sys_.diff_batch(np.tile(fx, len(kp)))
    for m in ("cost", "cost_x", "cost_u", "cost_xx", "cost_uu", "cost_ux",
              "cost_xu"):
        out[m] = [getattr(sys_, m)(x, u, k) for k in (0, *kp)]
    for m in ("cost_F", "cost_F_x", "cost_F_xx"):
        out[m] = getattr(sys_, m)(x)
    for sparse in (True, False):
        out[f"mu_{sparse}"] = sys_.get_mu_vector(sparse)
        out[f"Q_{sparse}"] = sys_.get_Q_matrix(sparse)
    sys_.reset()
    return out


def test_system_accessors_match_pylqr(both):
    got = {name: _accessors(sys_) for name, (_, sys_) in both.items()}
    for k in got["jax"]:
        _same(got["torch"][k], got["jax"][k], k)
    rbt, sys_ = both["torch"]
    x = sys_.get_init_state() + 0.2
    lim = sys_.forward_pass_with_limits(x, np.ones(DOF) * 0.1, 0)
    jlim = both["jax"][1].forward_pass_with_limits(x, np.ones(DOF) * 0.1, 0)
    _same(list(lim), list(jlim), "forward_pass_with_limits")
    np.testing.assert_allclose(rbt.get_q(), lim[0], atol=1e-12)  # driven
    for _, s in both.values():
        s.reset()
    np.testing.assert_allclose(rbt.get_q(), Q0, atol=1e-12)


def test_sequential_system_matches_pylqr():
    """POS_ORN_MULTI_SYS.ipynb cut to H=60: two TransformedSimulationInterfaces
    (one subscribed late), position-only via-points at 30 and 59 in their
    frames, a SequentialSystem; its accessors (the stacked mu and Q) at
    1e-12 and ILQRRecursive (riccati's twin at nq = 12) against PyLQR."""
    h = 60
    res = {}
    for name in ("jax", "torch"):
        pkg, kw = _pkg(name)
        rbt = pkg.sim.KDLRobot(URDF, "panda_link0", "panda_tip", Q0,
                               [0] * DOF, is_path=False, **kw)
        tr1 = pkg.sim.TransformedSimulationInterface(rbt, OBJ1)
        tr2 = pkg.sim.TransformedSimulationInterface(OBJ2)
        tr2.subscribe(rbt)
        qd = np.diag([1, 1, 1, 0, 0, 0])
        cmd = [1e-5] * DOF
        lim = (QMAX, -QMAX, np.ones(DOF) * 10, -np.ones(DOF) * 10)
        sys1 = pkg.system.PosOrnPlannerSys(
            tr1, [pkg.system.PosOrnKeypoint(np.array([0.0, 0.0, -0.15]),
                                            np.array([1.0, 0, 0, 0]), qd, h // 2)],
            cmd, *lim, h, 1, 0.01)
        sys2 = pkg.system.PosOrnPlannerSys(
            tr2, [pkg.system.PosOrnKeypoint(np.array([0.1, 0.1, -0.1]),
                                            np.array([1.0, 0, 0, 0]), qd, h - 1)],
            cmd, *lim, h, 1, 0.01)
        seq = pkg.system.SequentialSystem(rbt, [sys1, sys2], cmd, h, 1)
        acc = _accessors(seq)
        cb = Recorder()
        sol = pkg.solver.ILQRRecursive(seq).solve(np.zeros((h - 1, DOF)), 10,
                                                  True, True, cb)
        rbt.send_vel(0.01, np.ones(DOF) * 0.3)
        mirror = [(t.get_q(), t.get_ee_pos(), t.get_ee_orn(), t.get_time())
                  for t in (tr1, tr2)]
        res[name] = (acc, sol, cb.messages, mirror)
    (ja, js, jm, jmir), (ta, ts, tm, tmir) = res["jax"], res["torch"]
    assert ta["get_nb_target_var"] == 14 and ta["get_nb_Q_var"] == 12
    for k in ja:
        _same(ta[k], ja[k], k)
    assert tm == jm
    for i in range(3):
        np.testing.assert_allclose(ts[i], np.asarray(js[i]), atol=1e-9, rtol=0)
    np.testing.assert_allclose(ts[5], js[5], rtol=1e-9)
    _same([list(m) for m in tmir], [list(m) for m in jmir], "mirror")


def test_sim_wrappers_match_pylqr():
    """Robot2D (fkine, send_vel, set_conf) and KDLRobot's getters (J, the
    derivatives, velocities) on a moving state, at 1e-12 against PyLQR."""
    out = {}
    for name in ("jax", "torch"):
        pkg, kw = _pkg(name)
        rob = pkg.sim.Robot2D(np.array([1.0, 0.8]), np.array([0.3, 0.4]), **kw)
        vals = [rob.fkine(), rob.fkine([0.1, -0.7])]
        rob.send_vel(0.1, np.array([0.5, -0.2]), True)
        vals += [rob.get_q(), rob.get_time(), rob.fkine(), rob.get_ee_pos(),
                 rob.J(), rob.Jt()]
        rob.set_conf([0.0, 0.0], [0.0, 0.0], True)
        vals += [rob.get_time(), rob.fkine()]
        arm = pkg.sim.KDLRobot(URDF, "panda_link0", "panda_tip", [0.1] * 7,
                               [0.0] * 7, (0.1, 0.2, 0.3), (0.0, 0.0, 0.05),
                               False, **kw)
        arm.send_acc(0.05, np.linspace(-1, 1, 7))
        vals += [getattr(arm, m)() for m in (
            "get_q", "get_dq", "get_ee_pos", "get_ee_orn", "get_ee_vel",
            "get_ee_ang_vel", "get_ee_ang_vel_quat", "J", "Jp", "Jt", "Jr",
            "Jtp", "Jrp", "get_dof", "get_nb_car_dim", "get_time")]
        out[name] = vals
    _same(out["torch"], out["jax"], "sim")
    assert out["torch"][9] == pytest.approx([1.8, 0.0], abs=1e-12)


def test_sd_and_primitives_match_pylqr():
    import PyLQR

    rng = np.random.default_rng(2)
    q, r = (v / np.linalg.norm(v) for v in rng.normal(size=(2, 4)))
    v = rng.normal(size=4)
    u = v - (v @ q) * q
    for name, args in (("logMap", (q, r)), ("expMap", (q, u)),
                       ("distance", (q, r)), ("transport", (v, q, r)),
                       ("dquat_to_w_jac", (q,))):
        got = getattr(tcompat.utils.Sd, name)(*args)
        want = getattr(PyLQR.utils.Sd, name)(*args)
        _same(got, want if isinstance(got, float) else np.asarray(want), name)
    for name in ("build_psi_RBF", "build_psi_rbf", "build_psi_bernstein",
                 "build_psi_unitstep", "build_psi_sawtooth",
                 "build_psi_linear"):
        np.testing.assert_allclose(
            getattr(tcompat.utils.primitives, name)(99, 5),
            np.asarray(getattr(PyLQR.utils.primitives, name)(99, 5)),
            atol=1e-12, rtol=0)


def test_lqt_aliases_match_pylqr():
    import PyLQR

    A = np.array([[1.0, 0.1], [0, 1.0]])
    B = np.array([[0.005], [0.1]])
    Qs = np.zeros((20, 2, 2))
    Qs[-1] = np.eye(2)
    mu = np.zeros(40)
    mu[-2:] = [1.0, 0.0]
    got = tcompat.solver.LQT(A, B, Qs, mu, 0.01, 1, device="cpu")
    want = PyLQR.solver.LQT(A, B, Qs, mu, 0.01, 1)
    for lqt in (got, want):
        lqt.solve_lin_al()
    assert got.get_nb_states() == want.get_nb_states() == 20
    _same([got.get_command(0), got.get_predicted_states()],
          [np.asarray(want.get_command(0)),
           np.asarray(want.get_predicted_states())], "linalg")
    for lqt in (got, want):
        lqt.solve_DP()
    _same(got.get_command(0, mu[:2]), np.asarray(want.get_command(0, mu[:2])),
          "dp")


def test_concurrent_callbacks_do_not_interleave(both):
    """Two solves on two threads with their own callbacks each receive
    exactly their own iteration stream, on their own thread: ILQRRecursive
    (4 and 6 iterations) and BatchILQRCP / BatchILQR (3 and 5; early stop
    off pins the counts)."""
    _, sys_ = both["torch"]
    psi = np.kron(tcompat.utils.primitives.build_psi_unitstep(H - 1, 2),
                  np.eye(DOF))
    u0 = np.zeros(DOF * (H - 1))
    runs = {
        "a": (4, lambda cb: tcompat.solver.ILQRRecursive(sys_).solve(
            u0.reshape(-1, DOF), 4, True, False, cb)),
        "b": (6, lambda cb: tcompat.solver.ILQRRecursive(sys_).solve(
            u0.reshape(-1, DOF), 6, True, False, cb)),
        "cp": (3, lambda cb: tcompat.solver.BatchILQRCP(sys_, psi).solve(
            3, u0, False, cb)),
        "batch": (5, lambda cb: tcompat.solver.BatchILQR(sys_).solve(
            5, u0, False, cb)),
    }
    heard = {k: [] for k in runs}
    errs = []

    def run(k):
        me = threading.get_ident()
        cb = types.SimpleNamespace(
            notify=lambda m: heard[k].append((m, threading.get_ident() == me)))
        try:
            runs[k][1](cb)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(k,)) for k in runs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts) and not errs
    for k, (n, _) in runs.items():
        assert [int(m.split("Iteration ")[1].split(",")[0])
                for m, _ in heard[k]] == list(range(1, n + 1)), k
        assert all(own for _, own in heard[k]), k


def test_metrics_callback_reads_a_compat_solve(both):
    _, sys_ = both["torch"]
    cb = MetricsCallback()
    tcompat.solver.ILQRRecursive(sys_).solve(np.zeros((H - 1, DOF)), 10,
                                            True, True, cb)
    np.testing.assert_allclose(cb.costs, GOLDEN, rtol=2e-4)
    assert [r["iteration"] for r in cb.records] == list(range(1, 9))
    assert cb.alphas[-1] == pytest.approx(2.0 ** -10, rel=1e-5)


def test_cuda_default_raises_without_a_card(monkeypatch):
    """The robots default to CUDA and raise the port's error without a
    card; no compat object falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.sim.KDLRobot(URDF, "panda_link0", "panda_tip", Q0, [0] * DOF,
                             is_path=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.sim.Robot2D([1.0, 0.8], [0.3, 0.4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.solver.LQT(np.eye(2), np.ones((2, 1)), np.zeros((3, 2, 2)),
                           np.zeros(6), 0.01)


def test_systems_and_solvers_run_on_the_robots_device(both):
    """The Spec is built on the robot's device and dtype; the state mirror
    runs on the float64 CPU robot, kept whatever the robot's device and
    dtype, so a float32 robot's getters equal a float64 one's."""
    rbt, sys_ = both["torch"]
    assert sys_.spec.device == rbt.device == torch.device("cpu")
    assert sys_.spec.dtype == rbt.dtype == torch.float64
    assert sys_.spec.robot.chain.origin_pos.device == rbt.device
    mirror = rbt._robot_cpu.chain.origin_pos
    assert mirror.device.type == "cpu" and mirror.dtype == torch.float64
    r32 = tcompat.sim.KDLRobot(URDF, "panda_link0", "panda_tip", Q0,
                               [0] * DOF, is_path=False, device="cpu",
                               dtype=torch.float32)
    assert r32.robot.chain.origin_pos.dtype == torch.float32
    assert r32._robot_cpu.chain.origin_pos.dtype == torch.float64
    np.testing.assert_allclose(r32.get_ee_pos(), rbt.get_ee_pos(), atol=1e-12)
    t32 = tcompat.sim.TransformedSimulationInterface(r32, OBJ1)
    t64 = tcompat.sim.TransformedSimulationInterface(rbt, OBJ1)
    assert t32.robot.frame.dtype == torch.float32
    assert t32._robot_cpu.frame.dtype == torch.float64
    np.testing.assert_allclose(t32.get_ee_orn(), t64.get_ee_orn(), atol=1e-12)
