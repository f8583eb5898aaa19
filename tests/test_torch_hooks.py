"""Port parity, the solver hooks: `callback=` and `guard=` of
`ilqr_planner_torch.solvers.ilqr.solve` and `callback=` of
`solvers.batch.solve` / `solve_cp`, against the JAX package's, float64 on
the CPU (the AL solver's hooks: `tests/test_torch_al.py`).

Gates: the callback messages string-equal the JAX package's; a solve with a
callback gives the solve without one bit for bit (recursive; the batch
solver runs its reference-shaped body, as the JAX one does); results
against JAX at the tolerances of `tests/test_torch_ilqr.py` (iterations and
alpha equal, cost rtol 1e-9, X, U, Ks, ds 1e-8; the healthy workload
converges to a cost of 1.3e-8, where the two packages' rounding gives
8.9e-17 = 6.9e-9 relative, so the cost also passes within 1e-15
absolute) and, for the time-optimal
double integrator, whose unpivoted elimination amplifies rounding, X and U
1e-7 and Ks 1e-6 (entries up to 44, measured 8.9e-8); the guard's own
behavior at the JAX tests' bounds (`tests/test_systems_extra.py:203-236`).
"""

import threading

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.ops import primitives
from ilqr_planner_torch.solvers import batch as tbatch
from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.utils import CallBackMessage
from ilqr_planner_torch.utils.callbacks import progress_message
from ilqr_planner_torch.utils.convert import spec_like

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
QMAX = np.ones(7) * np.pi * 10


class Recorder(CallBackMessage):
    def __init__(self):
        self.messages = []
        self.threads = set()

    def notify(self, msg):
        self.messages.append(msg)
        self.threads.add(threading.get_ident())


def _jax_robot():
    from ilqr_planner_tpu.models import Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


def _healthy():
    """test_systems_extra.py:218-236's healthy workload: one via-point at
    39, H=40, dt=0.1, limits +-10 pi (JAX spec, U0)."""
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    kps = [PosOrnKeypoint([0.554, -0.0158, 0.383], [0.014, 0.915, 0.4025, 0.0223],
                          np.diag([1, 1, 1, .1, .1, .1]), 39)]
    spec = make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, 40, 1,
                     dt=0.1, q0=Q0, q_max=QMAX, q_min=-QMAX)
    return spec, np.zeros((39, 7))


def _sqrt_dt(H=50):
    """The POS_ORN_TIME_SYS_2ND workload of test_systems_extra.py:175-200:
    the time-optimal double integrator from the zero configuration, whose
    unguarded solve walks into NaN (JAX spec, U0)."""
    from ilqr_planner_tpu.systems.keypoints import SpacetimeKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    z = dict(dposition=[0, 0, 0], dorientation=[0, 0, 0, 0])
    kps = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0, .1]),
                             H // 2 - 1, 2.5, **z),
           SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, .1, .1, .1, .1]),
                             H - 1, 5.0, **z)]
    dqmax = np.ones(7) * 10.0
    spec = make_spec("posorn_time", _jax_robot(), kps, np.ones(8) * 1e-5, H, 2,
                     q0=np.zeros(7), q_max=QMAX, q_min=-QMAX, dq_max=dqmax,
                     dq_min=-dqmax)
    return spec, np.tile(np.array([0.0] * 7 + [0.01]), (H - 1, 1))


def _close(got, want, x_atol=1e-8, k_atol=1e-8):
    assert int(got.iterations) == int(want.iterations)
    assert float(got.alpha) == float(want.alpha)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-9,
                               atol=1e-15)
    for name, atol in (("X", x_atol), ("U", x_atol), ("Ks", k_atol),
                       ("ds", 1e-8)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_progress_message_is_the_jax_format():
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    class Capture:
        def notify(self, msg):
            self.msg = msg

    cap = Capture()
    for it, cost, alpha in ((3, 9.803739537660073e-07, 2.0 ** -10),
                            (1, np.float32(0.21419412), 1.0),
                            (20, float("nan"), 0.5), (7, 123456789.0, 0.25)):
        cb_id = jilqr._register_cb(cap)
        jilqr._emit_progress(cb_id, it, cost, alpha)
        jilqr._cb_registry.pop(cb_id)
        assert progress_message(it, cost, alpha) == cap.msg


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard"])
def test_callback_matches_jax(guard):
    """The healthy workload, 10 iterations: the messages string-equal the
    JAX package's, delivered on the caller's thread; the solve equals the
    solve without a callback bit for bit and the JAX solve at the
    tolerances."""
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, U0 = _healthy()
    jcb, tcb = Recorder(), Recorder()
    want = jilqr.solve(jspec, U0, 10, callback=jcb, guard=guard)
    tspec = spec_like(jspec, device="cpu")
    got = ilqr.solve(tspec, U0, 10, callback=tcb, guard=guard)
    quiet = ilqr.solve(tspec, U0, 10, guard=guard)
    assert tcb.messages == jcb.messages
    assert len(tcb.messages) == int(got.iterations) > 2
    assert tcb.threads == {threading.get_ident()}
    for f in ("X", "fX", "U", "Ks", "ds", "cost", "iterations", "alpha"):
        assert torch.equal(getattr(got, f), getattr(quiet, f)), f
    _close(got, want)


def test_guard_matches_jax_on_healthy_workload():
    """guard=True against the JAX guard (the sparse body: no callback) and
    against the port's unguarded solve, with the JAX test's bounds: U
    within 1e-5 and the guarded cost never above the unguarded one."""
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, U0 = _healthy()
    want = jilqr.solve(jspec, U0, 10, guard=True)
    tspec = spec_like(jspec, device="cpu")
    got = ilqr.solve(tspec, U0, 10, guard=True)
    _close(got, want)
    plain = ilqr.solve(tspec, U0, 10)
    np.testing.assert_allclose(plain.U.numpy(), got.U.numpy(), atol=1e-5)
    assert float(got.cost) <= float(plain.cost) * (1 + 1e-6)


def test_guard_contains_sqrt_dt_divergence():
    """The sqrt(dt) workload: with guard=True the port stops where the JAX
    package does (4 iterations, the floored alpha, the incumbent kept),
    with a finite cost <= the reference's last finite one (2.91514) and <=
    the one-iteration guarded cost; its messages string-equal the JAX
    callback's. The unguarded solve goes NaN in both packages."""
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, U0 = _sqrt_dt()
    jcb, tcb = Recorder(), Recorder()
    want = jilqr.solve(jspec, U0, 20, guard=True, callback=jcb)
    tspec = spec_like(jspec, device="cpu")
    got = ilqr.solve(tspec, U0, 20, guard=True, callback=tcb)
    assert tcb.messages == jcb.messages
    _close(got, want, x_atol=1e-7, k_atol=1e-6)
    cost = float(got.cost)
    assert np.isfinite(cost) and cost <= 2.91514
    assert got.U.isfinite().all() and got.X.isfinite().all()
    one = ilqr.solve(tspec, U0, 1, guard=True, early_stop=False)
    assert cost <= float(one.cost) + 1e-12
    # the guard keeps the incumbent: the last message repeats the cost
    # before it, at the floored alpha
    assert tcb.messages[-1].split(", alpha")[0].split("Cost: ")[1] == \
        tcb.messages[-2].split(", alpha")[0].split("Cost: ")[1]
    assert float(got.alpha) == 2.0 ** -10
    assert np.isnan(float(ilqr.solve(tspec, U0, 20).cost))


def test_guard_is_a_lane_mask():
    """In the batched body the guard freezes only the lanes whose line
    search floors out: each lane of a two-lane solve equals its solve
    alone."""
    jspec, U0 = _sqrt_dt(H=30)
    tspec = spec_like(jspec, device="cpu")
    x0s = torch.stack([tspec.x0, tspec.x0 + 0.05])
    U0s = torch.as_tensor(U0)[None].repeat(2, 1, 1)
    both = ilqr._solve_impl(tspec, x0s, U0s, 12, True, True, guard=True)
    for b in range(2):
        one = ilqr._solve_impl(tspec, x0s[b:b + 1], U0s[b:b + 1], 12, True,
                               True, guard=True)
        assert int(both.iterations[b]) == int(one.iterations[0])
        np.testing.assert_allclose(both.cost[b].item(), one.cost[0].item(),
                                   rtol=1e-12)
        np.testing.assert_allclose(both.U[b].numpy(), one.U[0].numpy(),
                                   atol=1e-10)


@pytest.mark.parametrize("cp", [False, True], ids=["gn", "cp"])
def test_batch_callback_matches_jax(cp):
    """BatchILQR / BatchILQRCP on the tutorial problem (H=100, 10
    iterations): the messages string-equal the JAX package's (its
    reference-shaped body: cost before the step, alpha); the port's
    callback solve equals its reference-shaped body without one bit for
    bit, and JAX at u 1e-9, cost rtol 1e-9."""
    from ilqr_planner_tpu.solvers import batch as jbatch
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    qd = np.diag([1, 1, 1, .1, .1, .1])
    kps = [PosOrnKeypoint(*T1, qd, 49), PosOrnKeypoint(*T2, qd, 99)]
    jspec = make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, 100, 1,
                      dt=0.1, q0=Q0, q_max=QMAX, q_min=-QMAX)
    kp, u0 = (49, 99), np.zeros(99 * 7)
    psi = np.kron(primitives.build_psi_unitstep(99, 2), np.eye(7))
    jcb, tcb = Recorder(), Recorder()
    tspec = spec_like(jspec, device="cpu")
    if cp:
        want = jbatch.solve_cp(jspec, psi, kp, 10, u0, callback=jcb)
        got = tbatch.solve_cp(tspec, psi, kp, 10, u0, callback=tcb)
    else:
        want = jbatch.solve(jspec, kp, 10, u0, callback=jcb)
        got = tbatch.solve(tspec, kp, 10, u0, callback=tcb)
    assert tcb.messages == jcb.messages
    assert tcb.threads == {threading.get_ident()}
    assert tcb.messages[0].startswith("Iteration 1, Cost: 0.506613, ")
    ref = tbatch._solve_impl(tspec, tbatch.sparse_Q(tspec, kp),
                             torch.tensor(psi) if cp else None,
                             tspec.x0[None], torch.tensor(u0)[None], kp, 10,
                             True, cp, False)
    assert torch.equal(got.u, ref.u[0]) and torch.equal(got.cost, ref.cost[0])
    assert int(got.iterations) == int(want.iterations) == len(jcb.messages)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-9)
