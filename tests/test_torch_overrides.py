"""Port parity, per-scenario keypoint overrides, `record=True` and the
staged schedule: the port's fleet (make_fleet_solver(overrides=...)), its
recursive route (solve_batch(prefer_fleet=False) on a spec whose
overridden leaves carry the scenario axis) and solve_batch_staged against
the JAX package's on the same float64 inputs on the CPU, where the port's
wrappers run the kernels' twins (segment_backward, `second`, `time1`, the
time-optimal rollout, riccati).

Tolerances: iterations and alpha equal per lane; cost rtol 1e-10; U and fX
atol 1e-9 (the JAX package's own fleet-vs-vmap tolerance,
tests/test_fleet.py:455-460); record buffers NaN where the JAX ones are,
alpha equal, cost rtol 1e-10.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.parallel import mesh, solve_batch, solve_batch_staged
from ilqr_planner_torch.solvers import ilqr
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
QD6 = [1, 1, 1, .1, .1, .1]
OV_NAMES = ("mu", "prec", "pos_radius", "orn_thresh")


def _keypoints(kind, nb, H, mod):
    if kind == "posorn" and nb == 1:
        return [mod.PosOrnKeypoint(*T1, np.diag(QD6), H // 2 - 1),
                mod.PosOrnKeypoint(*T2, np.diag(QD6), H - 1)]
    if kind == "posorn":
        z3, z4 = [0, 0, 0], [0, 0, 0, 0]
        qd = np.diag(QD6 + QD6)
        return [mod.PosOrnKeypoint(*T1, qd, H // 2 - 1, dposition=z3,
                                   dorientation=z4),
                mod.PosOrnKeypoint(*T2, qd, H - 1, dposition=z3,
                                   dorientation=z4)]
    return [mod.SpacetimeKeypoint(*T1, np.diag(QD6 + [0]), H // 2 - 1, 2.0),
            mod.SpacetimeKeypoint(*T2, np.diag(QD6 + [.1]), H - 1, 5.0)]


def _specs(kind="posorn", nb=1, H=40):
    """The same problem in both packages (the JAX package's
    tests/test_fleet.py:_posorn_spec_h at nb_deriv 1), limits +-10 pi."""
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
    qmax = np.ones(7) * np.pi * 10
    kw = dict(dt=None if time_kind else (0.1 if nb == 1 else 0.02), q0=Q0,
              q_max=qmax, q_min=-qmax)
    Rt = np.ones(8 if time_kind else 7) * 1e-5
    return (jmake_spec(kind, jrobot, _keypoints(kind, nb, H, jkps_mod), Rt, H,
                       nb, dtype=np.float64, **kw),
            make_spec(kind, robot, _keypoints(kind, nb, H, kps_mod), Rt, H, nb,
                      device="cpu", **kw))


def _overrides(jspec, B, seed=5):
    """Per-lane overrides made from a seed (the JAX package's
    tests/test_fleet.py:427 recipe): the terminal target moved, the
    terminal precision scaled by U(1, 1.5), a dead-zone radius U(0, 0.01)
    at the inner keypoint, zero thresholds; and x0."""
    H = jspec.horizon
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    x0s = np.concatenate([q0s, np.zeros((B, jspec.nx - 7))], axis=-1)
    mu = np.tile(np.asarray(jspec.mu)[None], (B, 1, 1))
    mu[:, H - 1, :3] += 0.05 * rng.normal(size=(B, 3))
    prec = np.tile(np.asarray(jspec.prec)[None], (B, 1, 1, 1))
    prec[:, H - 1] *= 1.0 + 0.5 * rng.random(size=(B, 1, 1))
    rad = np.zeros((B, H))
    rad[:, H // 2 - 1] = 0.01 * rng.random(B)
    return {"q0": q0s, "x0": x0s, "mu": mu, "prec": prec, "pos_radius": rad,
            "orn_thresh": np.zeros((B, H, 3))}


def _U0s(spec, B):
    U0s = np.zeros((B, spec.horizon - 1, spec.nu))
    if spec.time_optimal:
        U0s[..., -1] = 0.1
    return U0s


def _assert_matches(got, ref, fX=True):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    for name in ("U", "fX") if fX else ("U",):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-9,
                                   rtol=0, err_msg=name)


def _assert_progress(got, ref):
    """The record buffers: NaN at the same entries, alpha equal, cost rtol
    1e-10; and each lane's last recorded cost is its final cost."""
    for name in ("cost", "alpha"):
        g, r = got.progress[name].numpy(), np.asarray(ref.progress[name])
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
    np.testing.assert_array_equal(got.progress["alpha"].numpy(),
                                  np.asarray(ref.progress["alpha"]))
    np.testing.assert_allclose(got.progress["cost"].numpy(),
                               np.asarray(ref.progress["cost"]), rtol=1e-10,
                               atol=0)
    it = got.iterations.long()
    lanes = torch.arange(len(it))
    assert torch.equal(got.progress["cost"][lanes, it - 1], got.cost)
    cols = torch.arange(got.progress["cost"].shape[1])[None]
    assert torch.equal(torch.isnan(got.progress["cost"]), cols >= it[:, None])


@pytest.mark.parametrize("kind,nb", [("posorn", 1), ("posorn", 2),
                                     ("posorn_time", 1)],
                         ids=["first_order", "second_order", "time_optimal"])
def test_fleet_overrides_match_jax(kind, nb):
    """All four overrides at once through the fleet: the first-order sweep,
    the double integrator's `second` and the time-optimal `time1` with one
    rollout a trial (twins on the CPU), against the JAX fleet with the same
    overrides (its tests/test_fleet.py:427 problem, H = 40, B = 3, 4
    iterations without early stop)."""
    from ilqr_planner_tpu.solvers.fleet import make_fleet_solver as jmake

    jspec, spec = _specs(kind, nb)
    B = 3
    ov = _overrides(jspec, B)
    U0s = _U0s(spec, B)
    lanes = {k: ov[k] for k in OV_NAMES}
    ref = jmake(jspec, 4, early_stop=False, overrides=OV_NAMES,
                backward="xla", rollout="xla")(ov["x0"], U0s, lanes)
    got = make_fleet_solver(spec, 4, early_stop=False,
                            overrides=OV_NAMES)(ov["x0"], U0s, lanes)
    _assert_matches(got, ref)
    # through solve_batch: the same fleet solve, memoized with the names
    again = solve_batch(spec, ov, U0s, 4, early_stop=False)
    assert torch.equal(again.cost, got.cost) and torch.equal(again.U, got.U)
    # the entry just used is the LRU's last; other files' solves (an AL
    # fleet's key has another layout) may share this process's memo
    assert set(next(reversed(mesh._fleet_cache))[-2]) == set(OV_NAMES)


@pytest.fixture(scope="module")
def first_order():
    """The first-order problem (H = 40, B = 3) with all four overrides."""
    jspec, spec = _specs()
    return jspec, spec, _overrides(jspec, 3), _U0s(spec, 3)


@pytest.mark.parametrize("names", [("mu",), ("prec",), ("pos_radius",),
                                   ("orn_thresh",), OV_NAMES],
                         ids=["mu", "prec", "pos_radius", "orn_thresh", "all"])
def test_recursive_overrides_match_jax(first_order, names, monkeypatch):
    """Each override alone, and all four, through the recursive route
    against the JAX vmap path batching the same leaves. A per-lane prec
    takes the generic recursion (the riccati kernel's precisions are the
    same for every lane); the other overrides change only the residual and
    stay on riccati."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec, ov_all, U0s = first_order
    ov = {"q0": ov_all["q0"], "x0": ov_all["x0"],
          **{k: ov_all[k] for k in names}}
    if names == ("orn_thresh",):       # live thresholds at the inner keypoint
        th = np.zeros_like(ov_all["orn_thresh"])
        th[:, jspec.horizon // 2 - 1] = 0.02
        ov["orn_thresh"] = th
    calls = []
    riccati = ilqr.riccati_backward
    monkeypatch.setattr(ilqr, "riccati_backward",
                        lambda *a: calls.append(1) or riccati(*a))
    ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False, prefer_fleet=False)
    got = solve_batch(spec, ov, U0s, 4, early_stop=False, prefer_fleet=False)
    _assert_matches(got, ref)
    assert bool(calls) == ("prec" not in names)


def test_record_matches_jax_on_both_paths(first_order):
    """record=True with early stop, 12 iterations, so that lanes stop at
    different iterations: the fleet's and the recursive route's progress
    against the JAX package's, NaN beyond each lane's last iteration; and
    ilqr.solve(record=True) against the JAX solve's."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch
    from ilqr_planner_tpu.solvers import ilqr as jilqr

    jspec, spec, ov, U0s = first_order
    for prefer in (True, False):
        ref = jsolve_batch(jspec, ov, U0s, 12, prefer_fleet=prefer, record=True)
        got = solve_batch(spec, ov, U0s, 12, prefer_fleet=prefer, record=True)
        _assert_matches(got, ref)
        _assert_progress(got, ref)
    assert len(set(got.iterations.tolist())) > 1
    one = ilqr.solve(spec, U0s[0], 8, record=True)
    jone = jilqr.solve(jspec, U0s[0], 8, record=True)
    assert one.progress["cost"].shape == (8,)
    np.testing.assert_array_equal(np.isnan(one.progress["cost"].numpy()),
                                  np.isnan(np.asarray(jone.progress["cost"])))
    np.testing.assert_allclose(one.progress["cost"].numpy(),
                               np.asarray(jone.progress["cost"]), rtol=1e-10)
    assert ilqr.solve(spec, U0s[0], 8).progress is None


def test_staged_matches_plain_and_jax(first_order):
    """solve_batch_staged (first stage 8 of 12 iterations, buckets of 2
    lanes: some lanes stop in the first stage, the others are solved again)
    gives plain solve_batch's lanes, on both routes, and the JAX package's
    staged result; record=True raises, as in the JAX package. A lane solved
    in a smaller batch may round otherwise on the CPU (torch's reductions
    may take another path at another batch size): iterations and alpha
    equal, cost rtol 1e-10, every other field atol 1e-9."""
    from ilqr_planner_tpu.parallel import solve_batch_staged as jstaged

    jspec, spec, ov, U0s = first_order
    for prefer in (True, False):
        plain = solve_batch(spec, ov, U0s, 12, prefer_fleet=prefer)
        got = solve_batch_staged(spec, ov, U0s, 12, first_stage=8, bucket=2,
                                 prefer_fleet=prefer)
        assert 0 < int((plain.iterations > 8).sum()) < 3
        assert torch.equal(got.iterations, plain.iterations)
        assert torch.equal(got.alpha, plain.alpha)
        np.testing.assert_allclose(got.cost.numpy(), plain.cost.numpy(),
                                   rtol=1e-10, atol=0)
        for name in ("X", "U", "fX", "Ks", "ds"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       getattr(plain, name).numpy(), rtol=0,
                                       atol=1e-9, err_msg=name)
        ref = jstaged(jspec, ov, U0s, 12, first_stage=8, bucket=2,
                      prefer_fleet=prefer)
        _assert_matches(got, ref)
    with pytest.raises(ValueError, match="record=True"):
        solve_batch_staged(spec, ov, U0s, 12, record=True)


def test_override_errors():
    """A missing override array, a wrong shape, and a list on a plain spec
    raise; a per-lane leaf the fleet does not bind (state_max) takes the
    recursive route, as in the JAX package, and matches its lanes."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec = _specs(H=20)
    U0s = _U0s(spec, 2)
    solver = make_fleet_solver(spec, 2, overrides=("mu",))
    with pytest.raises(ValueError, match="missing override arrays"):
        solver(np.tile(Q0, (2, 1)), U0s, {})
    with pytest.raises(ValueError, match=r"override 'mu' must be \[B, 20, 7\]"):
        solver(np.tile(Q0, (2, 1)), U0s, {"mu": np.zeros((2, 20, 6))})
    with pytest.raises(ValueError, match="only for sequential"):
        solve_batch(spec, {"mu": [np.zeros((2, 20, 7))]}, U0s, 2)
    with pytest.raises(ValueError, match="only for sequential"):
        solve_batch(spec, {"mu": [np.zeros((2, 20, 7))]}, U0s, 2,
                    prefer_fleet=False)
    smax = np.stack([np.full(7, 10 * np.pi), np.full(7, 0.5)])
    ref = jsolve_batch(jspec, {"state_max": smax}, U0s, 2, prefer_fleet=False)
    _assert_matches(solve_batch(spec, {"state_max": smax}, U0s, 2), ref)
