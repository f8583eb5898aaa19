"""Port parity, the batch (Gauss-Newton) iLQR solver (`solvers/batch.py`,
`parallel.solve_batch_gn`), the pivoted linear algebra
(`ops/linalg.py`) and the control primitives (`ops/primitives.py`),
against the JAX package in float64 on the CPU.

  * `solve_ge` / `inv_ge` (inputs whose first pivots are small, so that
    rows swap) and `inv_spd`, batched, at 1e-12 of the largest output;
    the five primitive builders bit for bit;
  * both bodies (the closed-form `_solve_body_fast`, through the public
    `solve` / `solve_cp`, and the reference-shaped `_solve_body`), plain
    (GN) and control-primitive (CP), against the JAX `_solve_impl` with
    the same body on the five configurations of the JAX package's
    tests/test_batch_fast.py, cut: the second-order CP with limits from
    H=400 to H=100, the two object frames from H=600 to H=60 (targets at
    30 and 59; the reference-shaped body's dense [(H-1) nu]^2 system and
    the JAX programs' compile time); the flagship first order (H=100), the
    time-optimal first order (H=100) and second order (H=60) as there. The flagship also runs CP (the
    bench_table.py row batch_cp). u within 1e-9, cost rtol 1e-9,
    iterations equal; the time-optimal kinds at the JAX test's own 1e-6
    (u) and rtol 1e-6 (cost), early stop off;
  * `solve_batch_gn` on 4 lanes with per-lane `x0` and `mu` overrides, GN
    and CP, lane by lane against the JAX `solve_batch_gn`;
  * a per-lane `prec` override raises; `callback=` hears each iteration
    (its parity with the JAX messages: `tests/test_torch_hooks.py`).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.ops import linalg as tlinalg
from ilqr_planner_torch.ops import primitives as tprim
from ilqr_planner_torch.parallel import solve_batch_gn
from ilqr_planner_torch.solvers import batch as tbatch
from ilqr_planner_torch.utils.convert import spec_like

Q0 = [0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
      1.50592777, 0.71771416]
T1_POS = [0.554121212377707, -0.01575049935289518, 0.38295604872511507]
T1_ORN = [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
          0.022333898196169735]
T2_POS = [0.254121212377707, -0.07575049935289518, 0.13170744424127526]
T2_ORN = [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
          0.00011933313484481926]
QD6 = [1, 1, 1, 0.1, 0.1, 0.1]
QMAX = np.ones(7) * np.pi * 10


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# linear algebra and primitives
# ---------------------------------------------------------------------------

def _pivot_inputs():
    """[3, 4, 6, 6] systems whose leading entries are small (and one exact
    zero), so Gauss-Jordan swaps rows at the first columns."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 4, 6, 6))
    A[..., 0, 0] = 1e-3
    A[..., 1, 1] = 1e-4
    A[0, 0, 0, 0] = 0.0
    return A, rng.normal(size=(3, 4, 6, 2)), rng.normal(size=(3, 4, 6))


def test_solve_ge_inv_ge_match_jax():
    from ilqr_planner_tpu.ops import linalg as jlinalg

    A, B, v = _pivot_inputs()
    col = np.abs(A[..., :, 0])
    assert (col.argmax(-1) != 0).all()          # every element swaps row 0
    for rhs in (B, v):
        _close(tlinalg.solve_ge(torch.tensor(A), torch.tensor(rhs)).numpy(),
               jlinalg.solve_ge(jnp.asarray(A), jnp.asarray(rhs)), 1e-12)
    _close(tlinalg.solve_ge(torch.tensor(A[1, 2]), torch.tensor(B[1, 2])).numpy(),
           jlinalg.solve_ge(jnp.asarray(A[1, 2]), jnp.asarray(B[1, 2])), 1e-12)
    _close(tlinalg.inv_ge(torch.tensor(A)).numpy(),
           jlinalg.inv_ge(jnp.asarray(A)), 1e-12)
    X = tlinalg.solve_ge(torch.tensor(A), torch.tensor(B)).numpy()
    _close(A @ X, B, 1e-12)


def test_inv_spd_matches_jax():
    from ilqr_planner_tpu.ops import linalg as jlinalg

    A, _, _ = _pivot_inputs()
    S = A @ np.swapaxes(A, -1, -2) + 1e-6 * np.eye(6)
    _close(tlinalg.inv_spd(torch.tensor(S)).numpy(),
           jlinalg.inv_spd(jnp.asarray(S)), 1e-12)


@pytest.mark.parametrize("name", ["rbf", "bernstein", "unitstep", "sawtooth",
                                  "linear"])
def test_primitives_match_jax_bit_for_bit(name):
    from ilqr_planner_tpu.ops import primitives as jprim

    fn = f"build_psi_{name}"
    # (7, 7): one-wide windows, where the sawtooth divides 0 by 0
    for dim, K in ((99, 2), (99, 5), (40, 3), (7, 7)):
        with np.errstate(divide="ignore", invalid="ignore"):
            want = getattr(jprim, fn)(dim, K)
            got = getattr(tprim, fn)(dim, K)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want, equal_nan=True)


# ---------------------------------------------------------------------------
# the five configurations
# ---------------------------------------------------------------------------

def _jax_robot():
    from ilqr_planner_tpu.models import Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


def _config(name):
    """(JAX spec, kp_idx, u0, nb_iter, psi or None for GN, early_stop,
    tolerance) of one of test_batch_fast.py's problems (cut, see the module
    docstring)."""
    from ilqr_planner_tpu.ops import primitives as jprim
    from ilqr_planner_tpu.ops import so3
    from ilqr_planner_tpu.systems.keypoints import (PosOrnKeypoint,
                                                    SpacetimeKeypoint)
    from ilqr_planner_tpu.systems.spec import make_spec, sequential_spec

    robot = _jax_robot()
    if name.startswith("first_order"):
        kps = [PosOrnKeypoint(T1_POS, T1_ORN, np.diag(QD6), 49),
               PosOrnKeypoint(T2_POS, T2_ORN, np.diag(QD6), 99)]
        spec = make_spec("posorn", robot, kps, np.ones(7) * 1e-5, 100, 1,
                         dt=0.1, q0=Q0, q_max=QMAX, q_min=-QMAX)
        psi = np.kron(jprim.build_psi_unitstep(99, 2), np.eye(7))
        return (spec, (49, 99), np.zeros(99 * 7), 10,
                psi if name.endswith("cp") else None, True, 1e-9)
    if name == "second_order_cp_limits":
        H = 100
        qd_a = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0])
        qd_b = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, .1, .1, .1])
        kps = [PosOrnKeypoint(T1_POS, T1_ORN, qd_a, H // 2 - 1,
                              dposition=[0, 0, 0], dorientation=[0, 0, 0, 0]),
               PosOrnKeypoint(T2_POS, T2_ORN, qd_b, H - 1,
                              dposition=[0, 0, 0], dorientation=[0, 0, 0, 0])]
        spec = make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 2,
                         dt=0.01, q0=Q0, q_max=QMAX, q_min=-QMAX,
                         dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10)
        psi = np.kron(jprim.build_psi_sawtooth(H - 1, 2), np.eye(7))
        return (spec, (H // 2 - 1, H - 1), np.zeros((H - 1) * 7), 6, psi,
                True, 1e-9)
    if name == "sequential_frames":
        H, dt = 60, 0.01
        frames = []
        for quat, pos in (([0.63758403393523, 0.2994657314658187,
                            0.6042309402208079, -0.37244039285286973],
                           [0.62, 0.05, 0.34]),
                          ([-0.03647984, 0.94060485, 0.33742794, 0.00860923],
                           [0.32, 0.05, 0.54])):
            T = np.eye(4)
            T[:3, :3] = np.asarray(so3.quat_to_mat(np.array(quat)))
            T[:3, 3] = pos
            frames.append(T)
        qd = np.diag([1, 1, 1, 0, 0, 0])
        cmd = np.ones(7) * 1e-5
        sub1 = make_spec("posorn", robot.with_frame(frames[0]),
                         [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], qd, H // 2)],
                         cmd, H, 1, dt=dt, q0=Q0, q_max=QMAX, q_min=-QMAX)
        sub2 = make_spec("posorn", robot.with_frame(frames[1]),
                         [PosOrnKeypoint([0.1, 0.1, -0.1], [1, 0, 0, 0], qd, H - 1)],
                         cmd, H, 1, dt=dt, q0=Q0, q_max=QMAX, q_min=-QMAX)
        return (sequential_spec((sub1, sub2), cmd), (H // 2, H - 1),
                np.zeros((H - 1) * 7), 8, None, True, 1e-9)
    if name.startswith("time_first_order"):
        H = 100
        kps = [SpacetimeKeypoint(T1_POS, T1_ORN, np.diag(QD6 + [0]), H // 2 - 1, 2.0),
               SpacetimeKeypoint(T2_POS, T2_ORN, np.diag(QD6 + [0.1]), H - 1, 5.0)]
        spec = make_spec("posorn_time", robot, kps, np.ones(8) * 1e-5, H, 1,
                         q0=np.zeros(7), q_max=QMAX, q_min=-QMAX)
        u0 = np.tile([0.0] * 7 + [0.01], H - 1)
        if name.endswith("cp"):
            psi = np.kron(jprim.build_psi_unitstep(H - 1, 2), np.eye(8))
            return spec, (H // 2 - 1, H - 1), u0, 10, psi, False, 1e-6
        return spec, (H // 2 - 1, H - 1), u0, 8, None, False, 1e-6
    H = 60                                           # time_second_order
    qd = np.diag(QD6 + [1, 1, 1, 0, 0, 0] + [0.1])
    kps = [SpacetimeKeypoint(T1_POS, T1_ORN, qd, H - 1, 3.0,
                             dposition=[0, 0, 0], dorientation=[0, 0, 0, 0])]
    spec = make_spec("posorn_time", robot, kps, np.ones(8) * 1e-5, H, 2,
                     q0=np.zeros(7), q_max=QMAX, q_min=-QMAX,
                     dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10)
    return (spec, (H - 1,), np.tile([0.0] * 7 + [0.01], H - 1), 5, None,
            False, 1e-6)


CONFIGS = ["first_order", "first_order_cp", "second_order_cp_limits",
           "sequential_frames", "time_first_order", "time_first_order_cp",
           "time_second_order"]


@pytest.mark.parametrize("body", ["fast", "reference"])
@pytest.mark.parametrize("name", CONFIGS)
def test_batch_solver_matches_jax(name, body):
    """One body of one configuration against the JAX body of the same
    kind; the closed-form body through the public solve / solve_cp."""
    from ilqr_planner_tpu.solvers import batch as jbatch

    spec, kp_idx, u0, nb_iter, psi, early_stop, tol = _config(name)
    fast = body == "fast"
    Q = np.asarray(jbatch.sparse_Q(spec, kp_idx))
    use_psi = psi is not None
    want = jbatch._solve_impl(spec, Q, psi if use_psi else np.zeros((u0.size, 1)),
                              u0, kp_idx, nb_iter, early_stop, False, use_psi,
                              fast)
    tspec = spec_like(spec, device="cpu")
    assert tbatch.fast_supported(tspec)
    np.testing.assert_array_equal(tbatch.sparse_Q(tspec, kp_idx).numpy(), Q)
    np.testing.assert_array_equal(tbatch.sparse_mu(tspec, kp_idx).numpy(),
                                  np.asarray(jbatch.sparse_mu(spec, kp_idx)))
    if fast and use_psi:
        got = tbatch.solve_cp(tspec, psi, kp_idx, nb_iter, u0, early_stop)
    elif fast:
        got = tbatch.solve(tspec, kp_idx, nb_iter, u0, early_stop)
    else:
        res = tbatch._solve_impl(
            tspec, torch.tensor(Q), torch.tensor(psi) if use_psi else None,
            tspec.x0[None], torch.tensor(u0)[None], kp_idx, nb_iter,
            early_stop, use_psi, False)
        got = tbatch.BatchResult(res.u[0], res.cost[0], res.iterations[0])
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=tol)


# ---------------------------------------------------------------------------
# solve_batch_gn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cp", [False, True], ids=["gn", "cp"])
def test_solve_batch_gn_overrides_match_jax(cp):
    """4 lanes of the flagship problem at H=40 with per-lane x0 and mu,
    lane by lane against the JAX solve_batch_gn."""
    from ilqr_planner_tpu.ops import primitives as jprim
    from ilqr_planner_tpu.parallel import solve_batch_gn as jsolve_batch_gn
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    H, B = 40, 4
    kp_idx = (H // 2 - 1, H - 1)
    kps = [PosOrnKeypoint(T1_POS, T1_ORN, np.diag(QD6), kp_idx[0]),
           PosOrnKeypoint(T2_POS, T2_ORN, np.diag(QD6), kp_idx[1])]
    spec = make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, H, 1,
                     dt=0.1, q0=Q0, q_max=QMAX, q_min=-QMAX)
    rng = np.random.default_rng(11)
    x0s = np.asarray(Q0)[None] + 0.05 * rng.normal(size=(B, 7))
    mu = np.repeat(np.asarray(spec.mu)[None], B, axis=0)
    mu[:, kp_idx[0], :3] += 0.02 * rng.normal(size=(B, 3))
    u0s = 0.01 * rng.normal(size=(B, (H - 1) * 7))
    psi = (np.kron(jprim.build_psi_unitstep(H - 1, 3), np.eye(7)) if cp
           else None)
    want = jsolve_batch_gn(spec, kp_idx, {"x0": jnp.asarray(x0s),
                                          "mu": jnp.asarray(mu)},
                           jnp.asarray(u0s), 10, psi=psi)
    got = solve_batch_gn(spec_like(spec, device="cpu"), kp_idx,
                         {"x0": torch.tensor(x0s), "mu": torch.tensor(mu)},
                         u0s, 10, psi=psi)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-9)
    assert len(set(got.cost.tolist())) == B     # the lanes differ


def test_unsupported_arguments_raise():
    """A per-lane prec override (the JAX package builds Q once from the
    spec and would ignore it) and a wrong u0s shape raise; callback= works:
    one message an iteration, the cost before the step, the result that of
    the reference-shaped body."""
    from ilqr_planner_torch.models import Robot, chain_from_urdf
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    H = 10
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    spec = make_spec("posorn", robot,
                     [PosOrnKeypoint(T1_POS, T1_ORN, np.diag(QD6), H - 1)],
                     np.ones(7) * 1e-5, H, 1, dt=0.1, q0=Q0, device="cpu")
    u0s = np.zeros((2, (H - 1) * 7))
    prec = np.repeat(spec.prec.numpy()[None], 2, axis=0)
    with pytest.raises(NotImplementedError, match="prec"):
        solve_batch_gn(spec, (H - 1,), {"prec": prec}, u0s, 2)
    with pytest.raises(ValueError, match="u0s must be"):
        solve_batch_gn(spec, (H - 1,), {}, u0s[:, :-1], 2)
    for psi in (None, np.eye(u0s.shape[1])):
        heard = []
        cb = types.SimpleNamespace(notify=heard.append)
        if psi is None:
            got = tbatch.solve(spec, (H - 1,), 2, u0s[0], callback=cb)
        else:
            got = tbatch.solve_cp(spec, psi, (H - 1,), 2, u0s[0], callback=cb)
        ref = tbatch._solve_impl(
            spec, tbatch.sparse_Q(spec, (H - 1,)),
            None if psi is None else torch.tensor(psi), spec.x0[None],
            torch.tensor(u0s[:1]), (H - 1,), 2, True, psi is not None, False)
        assert torch.equal(got.u, ref.u[0])
        assert [m.split(",")[0] for m in heard] == [
            f"Iteration {i + 1}" for i in range(int(got.iterations))]
        assert heard[-1].split("Cost: ")[1].split(",")[0] == \
            f"{float(got.cost):g}"
