"""Port parity, the time-optimal double integrator (state [q, dq, t],
control [ddq, s], step duration s^2): the fleet's generic per-step sweep
(`ops/step_terms.py` 'time2', the fleet's semi-implicit Euler rollout) and
the recursive route, against the JAX package in float64 on the CPU.

The JAX references are its recursive route (`solve_batch(...,
prefer_fleet=False)`), whose programs compile in seconds; the tolerances
are the JAX package's own for its fleet against that route
(tests/test_fleet.py): after one iteration without line search cost rtol
1e-12 (posorn_time) / 1e-9 (joint_time), U atol 1e-9, Ks atol 1e-10; after
four line-searched iterations behavioral agreement (cost rtol 1e-3), since
the sqrt(dt) acceleration control amplifies rounding chaotically (the
reference notebook diverges on this kind). `_q_terms` at one step 1e-12.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.ops.step_terms import q_terms
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers.fleet import fleet_supported
from ilqr_planner_torch.utils.convert import spec_like

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
HT, B = 20, 2
QT = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0, .1])
QMAX = np.ones(7) * np.pi * 10
DQMAX = np.ones(7) * 10.0


def _jax_robot():
    from ilqr_planner_tpu.models import Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


def _jax_spec(kind, steps=(HT - 1,)):
    """The JAX test's problems: a spacetime keypoint (at step k, t = 2.0
    (k + 1) / 20, zero velocity targets) or a joint-space one (t = 1.5,
    0.2 rad away) at each of `steps`; limits +-10 pi and +-10."""
    from ilqr_planner_tpu.systems.keypoints import (AngularTimeKeypoint,
                                                    SpacetimeKeypoint)
    from ilqr_planner_tpu.systems.spec import make_spec

    if kind == "posorn_time":
        kps = [SpacetimeKeypoint(*(T1 if k == HT - 1 else T2), QT, k,
                                 2.0 * (k + 1) / HT, dposition=[0, 0, 0],
                                 dorientation=[0, 0, 0, 0]) for k in steps]
    else:
        kps = [AngularTimeKeypoint(Q0 + 0.2, np.diag([1.0] * 7 + [0.01] * 7 + [0.1]),
                                   k, 1.5, dposition=np.zeros(7)) for k in steps]
    return make_spec(kind, _jax_robot(), kps, np.ones(8) * 1e-5, HT, 2, dt=None,
                     q0=Q0, q_max=QMAX, q_min=-QMAX, dq_max=DQMAX,
                     dq_min=-DQMAX, dtype=np.float64)


def _lanes(seed):
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.02 * rng.normal(size=(B, 7))
    x0s = np.concatenate([q0s, np.zeros((B, 7)), np.zeros((B, 1))], axis=-1)
    U0 = np.tile(np.array([0.0] * 7 + [0.1]), (HT - 1, 1))
    return q0s, x0s, np.tile(U0[None], (B, 1, 1))


def test_q_terms_time2_matches_jax():
    """The Q blocks at one step on seeded inputs (a dense keypoint Hessian,
    s away from zero) against the JAX fleet's `_q_terms`."""
    import jax.numpy as jnp
    from ilqr_planner_tpu.solvers import fleet as jfleet

    jspec = _jax_spec("posorn_time")
    cc = jfleet._Consts(jspec)
    n, m, dof, lanes = 15, 8, 7, 16
    rng = np.random.default_rng(2)
    M = rng.normal(size=(n, n, lanes))
    P = np.einsum("ikb,jkb->ijb", M, M)
    G = rng.normal(size=(n, n, lanes))
    gxx = np.einsum("ikb,jkb->ijb", G, G)
    p, l2, lx = (rng.normal(size=(n, lanes)) for _ in range(3))
    u = rng.normal(size=(m, lanes))
    u[-1] = 0.1 + 0.2 * rng.random(lanes)
    dq = rng.normal(size=(dof, lanes))

    def jrows(a):
        return jfleet._rows(jnp.asarray(a))

    ref = jfleet._q_terms(cc, jfleet._mat(jnp.asarray(P)), jrows(p), jrows(l2),
                          jrows(lx), jrows(u), jfleet._mat(jnp.asarray(gxx)),
                          dq=jrows(dq))
    Rt = torch.tensor(cc.Rt, dtype=torch.float64)[:, None]
    got = q_terms("time2", *(torch.as_tensor(a) for a in (P, p, l2, lx, u, gxx)),
                  0.0, 0.0, Rt, torch.as_tensor(dq))
    like = jnp.zeros(lanes)
    for name, g, r in zip(("Quu", "Qux", "Qu", "Qxx", "Qx"), got, ref):
        r = np.asarray(jfleet._to_arr([[jfleet._full(v, like) for v in row] for row in r])
                       if isinstance(r[0], list) else
                       jnp.stack([jfleet._full(v, like) for v in r]))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-12, rtol=1e-12,
                                   err_msg=name)


@pytest.fixture(scope="module")
def refs():
    """{kind: (jspec, lanes, {(nb_iter, line_search): JAX recursive-route
    result})}: one iteration without line search, four with."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve

    out = {}
    for kind, seed in (("posorn_time", 3), ("joint_time", 5)):
        jspec = _jax_spec(kind)
        q0s, x0s, U0s = _lanes(seed)
        out[kind] = (jspec, (x0s, U0s), {
            (nb, ls): jsolve(jspec, {"q0": q0s, "x0": x0s}, U0s, nb,
                             line_search=ls, early_stop=False, prefer_fleet=False)
            for nb, ls in ((1, False), (4, True))})
    return out


ROUTES = {"fleet": True, "recursive": False}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["posorn_time", "joint_time"])
def test_one_iteration_matches_jax(refs, kind, route):
    jspec, (x0s, U0s), ref = refs[kind]
    spec = spec_like(jspec, device="cpu")
    assert fleet_supported(spec) and spec.nx == 15 and spec.nu == 8
    got = solve_batch(spec, {"x0": x0s}, U0s, 1, line_search=False,
                      early_stop=False, prefer_fleet=ROUTES[route])
    r = ref[(1, False)]
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(r.cost),
                               rtol=1e-12 if kind == "posorn_time" else 1e-9)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(r.U), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.Ks.numpy(), np.asarray(r.Ks), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.fX.numpy(), np.asarray(r.fX), atol=1e-9, rtol=0)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["posorn_time", "joint_time"])
def test_four_iterations_behave_as_jax(refs, kind, route):
    jspec, (x0s, U0s), ref = refs[kind]
    spec = spec_like(jspec, device="cpu")
    got = solve_batch(spec, {"x0": x0s}, U0s, 4, early_stop=False,
                      prefer_fleet=ROUTES[route])
    r = ref[(4, True)]
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(r.cost), rtol=1e-3)
    if kind == "posorn_time":
        np.testing.assert_allclose(got.U.numpy(), np.asarray(r.U), rtol=0.05,
                                   atol=1e-3)
    else:
        np.testing.assert_allclose(got.U.numpy(), np.asarray(r.U), atol=1e-4)
    assert np.isfinite(got.cost.numpy()).all()
    # the time state integrates the step durations s^2
    np.testing.assert_allclose(got.X[:, -1, -1].numpy(),
                               (got.U[..., -1] ** 2).sum(-1).numpy(), rtol=1e-12)


def test_sequential_time2_on_fleet():
    """A sequential spec of two time-optimal double-integrator subsystems
    (a spacetime keypoint at 9 in one, at 19 in the other), on the fleet
    and on the recursive route, against the JAX recursive route: one
    iteration without line search."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve
    from ilqr_planner_tpu.systems.spec import sequential_spec

    subs = [_jax_spec("posorn_time", (k,)) for k in (HT // 2 - 1, HT - 1)]
    jspec = sequential_spec(subs, np.ones(8) * 1e-5, dtype=np.float64)
    spec = spec_like(jspec, device="cpu")
    assert fleet_supported(spec)
    q0s, x0s, U0s = _lanes(7)
    ref = jsolve(jspec, {"q0": q0s, "x0": x0s}, U0s, 1, line_search=False,
                 early_stop=False, prefer_fleet=False)
    for prefer in (True, False):
        got = solve_batch(spec, {"x0": x0s}, U0s, 1, line_search=False,
                          early_stop=False, prefer_fleet=prefer)
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   rtol=1e-12)
        np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(got.Ks.numpy(), np.asarray(ref.Ks),
                                   atol=1e-10, rtol=0)
