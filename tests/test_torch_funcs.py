"""Port parity, the system functions: `ilqr_planner_torch.systems.funcs`
against `ilqr_planner_tpu.systems.funcs` on the same float64 trajectories of
the Panda, for every kind the recursive solver takes (posorn, joint, point at
nb_deriv 1 and 2, posorn_time at 1) and, for `dynamics` / `constant_AB`, all
four integrator branches (the time-optimal double integrator on a Spec
carried across with `spec_from_arrays`, since `make_spec` does not build
that kind yet).

The JAX functions take one sample and are batched with vmap over one jitted
program per case; the port's take the whole [B, H] trajectory at once. The
states are q0 + noise with joint limits q0 +- 0.05, so part of every
trajectory lies outside its limits; one keypoint carries dead zones; the
all-zero forward map is a case of its own.

Tolerance 1e-12 absolute (the same arithmetic, sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec
from ilqr_planner_torch.utils.convert import spec_from_arrays

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
H, B = 8, 3
TOL = dict(atol=1e-12, rtol=0)
SPEC_LEAVES = ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
               "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
               "dq0")
CASES = (("posorn", 1), ("posorn", 2), ("joint", 1), ("joint", 2),
         ("point", 1), ("point", 2), ("posorn_time", 1))


def _keypoints(kind, nb, mod):
    """Two keypoints (steps 3 and H-1); the first posorn one has dead zones."""
    z3, z4 = [0, 0, 0], [0, 0, 0, 0]
    d2 = nb == 2
    if kind == "posorn":
        prec = np.diag([1, 1, 1, .1, .1, .1] * nb)
        vel = dict(dposition=z3, dorientation=z4) if d2 else {}
        return [mod.PosOrnKeypointDistFunct(*T1, prec, 3, pos_radius=0.02,
                                            orn_thresh=(0.01, 0.0, 0.3), **vel),
                mod.PosOrnKeypoint(*T2, prec, H - 1, **vel)]
    if kind == "point":
        vel = dict(dposition=z3) if d2 else {}
        return [mod.PointKeypoint(T1[0], np.eye(3 * nb), 3, **vel),
                mod.PointKeypoint(T2[0], np.eye(3 * nb), H - 1, **vel)]
    if kind == "joint":
        vel = dict(dposition=np.zeros(7)) if d2 else {}
        return [mod.AngularKeypoint(Q0 - 0.2, np.eye(7 * nb), 3, **vel),
                mod.AngularKeypoint(Q0 + 0.3, np.eye(7 * nb), H - 1, **vel)]
    vel = dict(dposition=z3, dorientation=z4) if d2 else {}
    w = [1, 1, 1, .1, .1, .1] * nb
    return [mod.SpacetimeKeypoint(*T1, np.diag(w + [0]), 3, 2.0, **vel),
            mod.SpacetimeKeypoint(*T2, np.diag(w + [.1]), H - 1, 5.0, **vel)]


def _robots():
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf

    jrobot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    return jrobot, robot


def _specs(kind, nb):
    """The same problem for both packages, joint limits q0 +- 0.05 (velocity
    limits +-0.1 at nb_deriv 2) so the penalty is live."""
    from ilqr_planner_tpu.systems import keypoints as jkps_mod
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot, robot = _robots()
    time_kind = kind.endswith("_time")
    kw = dict(dt=None if time_kind else 0.1, q0=Q0, q_max=Q0 + 0.05,
              q_min=Q0 - 0.05)
    if nb == 2:
        kw.update(dq_max=np.ones(7) * 0.1, dq_min=-np.ones(7) * 0.1)
    Rt = np.ones(8 if time_kind else 7) * 1e-5
    jspec = jmake_spec(kind, jrobot, _keypoints(kind, nb, jkps_mod), Rt, H, nb,
                       dtype=np.float64, **kw)
    if time_kind and nb == 2:   # the port's make_spec does not build it yet
        fields = {k: getattr(jspec, k) for k in
                  ("kind", "nb_deriv", "horizon", "limits_set")}
        fields.update({k: np.asarray(getattr(jspec, k)) for k in SPEC_LEAVES})
        return jspec, spec_from_arrays(fields, robot, device="cpu")
    spec = make_spec(kind, robot, _keypoints(kind, nb, kps_mod), Rt, H, nb,
                     device="cpu", **kw)
    return jspec, spec


def _trajectory(spec, seed=0):
    """(X [B, H, nx], U [B, H, nu]) as numpy: joint angles around q0, so that
    some lie outside q0 +- 0.05; velocities, times and controls random."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, H, spec.nx)) * 0.08
    X[..., :7] += Q0
    if spec.time_optimal:
        X[..., -1] = np.abs(X[..., -1]) * 10
    U = rng.normal(size=(B, H, spec.nu)) * 0.3
    return X, U


def _jax_terms(jspec, X, U):
    """Every per-step quantity of the JAX functions over [B, H], from one
    jitted program."""
    import jax
    import jax.numpy as jnp

    from ilqr_planner_tpu.systems import funcs as jfuncs

    def one(x, u, k):
        fx, J = jfuncs.fx_jac(jspec, x)
        e = jfuncs.residual(jspec, fx, k)
        ld, lq = jfuncs.limit_terms(jspec, x)
        cost = jfuncs.stage_cost(jspec, x, fx, u, k)
        final = jfuncs.final_cost(jspec, x, fx)
        l_x, l_u, l_xx = jfuncs.cost_gradients(jspec, x, fx, J, u, k)
        xn, A, Bm = jfuncs.dynamics(jspec, x, u)
        return dict(fx=fx, J=J, e=e, ld=ld, lq=lq, cost=cost, final=final,
                    l_x=l_x, l_u=l_u, l_xx=l_xx, xn=xn, A=A, B=Bm,
                    prec=jfuncs.prec_at(jspec, k),
                    ctrl=jfuncs.ctrl_cost(jspec, u, k))

    ks = jnp.arange(H)
    over_steps = jax.vmap(one, in_axes=(0, 0, 0))
    out = jax.jit(jax.vmap(lambda x, u: over_steps(x, u, ks)))(
        jnp.asarray(X), jnp.asarray(U))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_terms(spec, X, U):
    X, U = torch.as_tensor(X), torch.as_tensor(U)
    ks = torch.arange(H)
    fx, J = funcs.fx_jac(spec, X)
    ld, lq = funcs.limit_terms(spec, X)
    l_x, l_u, l_xx = funcs.cost_gradients(spec, X, fx, J, U, ks)
    xn, A, Bm = funcs.dynamics(spec, X, U)
    out = dict(fx=fx, J=J, e=funcs.residual(spec, fx, ks), ld=ld, lq=lq,
               cost=funcs.stage_cost(spec, X, fx, U, ks),
               final=funcs.final_cost(spec, X, fx), l_x=l_x, l_u=l_u,
               l_xx=l_xx, xn=xn, A=A, B=Bm,
               prec=funcs.prec_at(spec, ks).expand(B, -1, -1, -1),
               ctrl=funcs.ctrl_cost(spec, U, ks))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("kind,nb", CASES)
def test_funcs_match_jax(kind, nb):
    """fx_jac, residual, limit_terms, stage_cost, final_cost, cost_gradients,
    prec_at, ctrl_cost and dynamics over a trajectory with states outside
    their limits."""
    jspec, spec = _specs(kind, nb)
    X, U = _trajectory(spec)
    ref, got = _jax_terms(jspec, X, U), _torch_terms(spec, X, U)
    assert ref["ld"].any() and not ref["ld"].all()     # limits partly live
    assert ref["e"][:, 3].any() and not ref["e"][:, 2].any()   # keypoint mask
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **TOL)
    # u'Ru enters the cost value at keypoint steps only, the gradient always
    assert got["ctrl"][:, 3].all() and not got["ctrl"][:, 2].any()
    assert got["l_u"][:, 2].any()

    # the forward map alone is the same tensor, bit for bit
    assert np.array_equal(funcs.fx(spec, torch.as_tensor(X)).numpy(), got["fx"])

    # a single state with an integer step, as the JAX functions are called
    x1, u1 = torch.as_tensor(X[0, 3]), torch.as_tensor(U[0, 3])
    fx1, J1 = funcs.fx_jac(spec, x1)
    np.testing.assert_allclose(fx1.numpy(), ref["fx"][0, 3], **TOL)
    np.testing.assert_allclose(funcs.stage_cost(spec, x1, fx1, u1, 3).numpy(),
                               ref["cost"][0, 3], **TOL)
    np.testing.assert_allclose(
        funcs.cost_gradients(spec, x1, fx1, J1, u1, 3)[2].numpy(),
        ref["l_xx"][0, 3], **TOL)


@pytest.mark.parametrize("kind,nb", [("posorn", 1), ("posorn", 2),
                                     ("posorn_time", 1)])
def test_zero_forward_map_guard_matches_jax(kind, nb):
    """An exactly zero forward map zeroes the position + orientation rows of
    the residual, and leaves the time row alone."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.systems import funcs as jfuncs

    jspec, spec = _specs(kind, nb)
    fx = np.zeros(spec.nt)
    if spec.time_optimal:
        fx[-1] = 0.7
    ref = np.asarray(jfuncs.residual(jspec, jnp.asarray(fx), 3))
    got = funcs.residual(spec, torch.as_tensor(fx), 3).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    rows = got[:-1] if spec.time_optimal else got
    assert not rows.any()
    if spec.time_optimal:
        assert got[-1] == spec.mu[3, -1].item() - 0.7
    # one zero row inside a batch is guarded on its own
    fxs = np.stack([fx, np.asarray(funcs.fx_jac(spec, spec.x0)[0])])
    both = funcs.residual(spec, torch.as_tensor(fxs), 3).numpy()
    np.testing.assert_allclose(both[0], ref, **TOL)
    assert both[1].any()


def test_orientation_dead_zone_at_its_threshold():
    """|r_o| exactly at the threshold is inside the dead zone; just beyond it
    the residual is shrunk by the threshold."""
    _, spec = _specs("posorn", 1)
    fx, _ = funcs.fx_jac(spec, spec.x0)
    plain = dataclasses.replace(spec, orn_thresh=torch.zeros_like(spec.orn_thresh),
                                pos_radius=torch.zeros_like(spec.pos_radius))
    r_o = funcs.residual(plain, fx, 3)[3:]
    th = spec.orn_thresh.clone()
    th[3] = r_o.abs()
    at = dataclasses.replace(plain, orn_thresh=th)
    assert not funcs.residual(at, fx, 3)[3:].any()
    below = dataclasses.replace(plain, orn_thresh=th * 0.5)
    np.testing.assert_allclose(funcs.residual(below, fx, 3)[3:].numpy(),
                               (0.5 * r_o).numpy(), atol=1e-15, rtol=0)


@pytest.mark.parametrize("kind,nb", [("posorn", 1), ("joint", 2),
                                     ("joint_time", 1), ("posorn_time", 2)],
                         ids=["first", "second", "time_first", "time_second"])
def test_dynamics_branches_match_jax(kind, nb):
    """All four integrators: x', A, B per sample, and constant_AB."""
    import jax
    import jax.numpy as jnp

    from ilqr_planner_tpu.systems import funcs as jfuncs

    if kind == "joint_time":
        from ilqr_planner_tpu.systems import keypoints as jkps_mod
        from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

        jrobot, robot = _robots()
        kp = lambda mod: [mod.AngularTimeKeypoint(  # noqa: E731
            Q0 + 0.3, np.diag([1] * 7 + [.1]), H - 1, 5.0)]
        jspec = jmake_spec(kind, jrobot, kp(jkps_mod), np.ones(8) * 1e-5, H, 1,
                           dtype=np.float64, q0=Q0)
        spec = make_spec(kind, robot, kp(kps_mod), np.ones(8) * 1e-5, H, 1,
                         q0=Q0, device="cpu")
    else:
        jspec, spec = _specs(kind, nb)
    X, U = _trajectory(spec, seed=1)
    step = jax.jit(jax.vmap(jax.vmap(lambda x, u: jfuncs.dynamics(jspec, x, u))))
    ref = [np.asarray(a) for a in step(jnp.asarray(X), jnp.asarray(U))]
    got = funcs.dynamics(spec, torch.as_tensor(X), torch.as_tensor(U))
    for g, r, name in zip(got, ref, ("x_next", "A", "B")):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)
    np.testing.assert_allclose(
        funcs._next_state(spec, torch.as_tensor(X), torch.as_tensor(U)).numpy(),
        ref[0], **TOL)

    jab = jfuncs.constant_AB(jspec, jnp.float64)
    ab = funcs.constant_AB(spec, torch.float64)
    if spec.time_optimal:
        assert jab is None and ab is None
        # the last column of B depends on the state or the control
        assert np.ptp(ref[2][..., :7, -1], axis=(0, 1)).all()
    else:
        for g, r in zip(ab, jab):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sequential_raises_not_implemented():
    """Sequential specs are ported; one without subsystems is refused."""
    _, spec = _specs("joint", 1)
    seq = dataclasses.replace(spec, kind="sequential")
    x = spec.x0
    for call in (lambda: funcs.fx_jac(seq, x),
                 lambda: funcs.fx(seq, x),
                 lambda: funcs.residual(seq, x, 0),
                 lambda: funcs.prec_at(seq, 0),
                 lambda: funcs.ctrl_cost(seq, x, 0),
                 lambda: funcs.constant_AB(seq, torch.float64),
                 lambda: funcs.dynamics(seq, x, x)):
        with pytest.raises(ValueError, match="at least one subsystem"):
            call()
