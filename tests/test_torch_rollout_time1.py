"""Port parity, the time-optimal trial rollout: the plain twin of the CUDA
kernel against the JAX fleet's scan rollout and against the JAX Pallas
kernel in interpret mode, in float64 on the CPU; the port's closed-loop
`_rollout` cost against the JAX one; the wrapper's CPU routing and its
argument checks. The kernel itself runs only on the card (marked `cuda`).

Tolerances: X and U 1e-12 absolute (the same per-step arithmetic);
sum ||du|| and the trial cost 1e-12 relative (sums in another order).
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
from ilqr_planner_torch.solvers import fleet
from ilqr_planner_torch.utils.convert import spec_from_arrays

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
H, B, ALPHA = 12, 128, 0.5


def _inputs(seed=9, Bl=B, n=8):
    """Random gains and a reference trajectory around q0 (its first n - 1
    joints and the time state), step controls s kept away from zero:
    (Ks, ds, Xref, Uref, x0) as numpy arrays."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([np.resize(Q0, n - 1)[None] + 0.05 * rng.normal(size=(Bl, n - 1)),
                         np.zeros((Bl, 1))], axis=-1)
    steps = np.concatenate([x0[None], 0.02 * rng.normal(size=(H - 1, Bl, n))])
    Xref = np.ascontiguousarray(np.cumsum(steps, axis=0).transpose(0, 2, 1))
    Uref = 0.05 * rng.normal(size=(H - 1, n, Bl))
    Uref[:, -1] = 0.1 + 0.05 * np.abs(Uref[:, -1])
    Ks = 0.1 * rng.normal(size=(H - 1, n, n, Bl))
    ds = 0.05 * rng.normal(size=(H - 1, n, Bl))
    return Ks, ds, Xref, Uref, x0.T.copy()


def _specs():
    """The posorn_time problem in both packages: spacetime keypoints at
    H/2 and H-1, joint limits q0 +- 0.4."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.systems.keypoints import SpacetimeKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    robot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    kps = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), H // 2,
                             2.0),
           SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, 0.1]), H - 1,
                             5.0)]
    jspec = jmake_spec("posorn_time", robot, kps, np.ones(8) * 1e-5, H, 1,
                       dt=None, q0=Q0, q_max=Q0 + 0.4, q_min=Q0 - 0.4,
                       dtype=np.float64)
    fields = {k: getattr(jspec, k) for k in
              ("kind", "nb_deriv", "horizon", "limits_set")}
    for k in ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
              "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
              "dq0"):
        fields[k] = np.asarray(getattr(jspec, k))
    chain = chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip", device="cpu")
    return jspec, spec_from_arrays(fields, Robot.from_chain(chain), device="cpu")


@pytest.fixture(scope="module")
def jax_rollouts():
    """The JAX scan rollout (X, U, cost, sum ||du||) and the Pallas kernel
    in interpret mode (X, U, ||du||^2) on the same inputs."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels import rollout_time1 as jrt1
    from ilqr_planner_tpu.solvers import fleet as jfleet

    jspec, spec = _specs()
    args = [jnp.asarray(a) for a in _inputs()]
    jcc = jfleet._Consts(jspec)
    scan = jfleet._rollout(jcc, ALPHA, *args)
    kern = jrt1.rollout_time1_pallas(jnp.float64(ALPHA), *args, interpret=True)
    return spec, [np.asarray(a) for a in scan], [np.asarray(a) for a in kern]


def test_twin_matches_jax_scan_and_pallas_interpret(jax_rollouts):
    _, scan, kern = jax_rollouts
    before = rt1.LAUNCHES
    X, U, du2 = rt1.rollout_time1(ALPHA, *(torch.as_tensor(a) for a in _inputs()))
    assert rt1.LAUNCHES == before                   # the CPU runs the twin
    assert X.shape == (H, 8, B) and U.shape == (H - 1, 8, B)
    for ref_X, ref_U in ((scan[0], scan[1]), (kern[0], kern[1])):
        np.testing.assert_allclose(X.numpy(), ref_X, atol=1e-12, rtol=0)
        np.testing.assert_allclose(U.numpy(), ref_U, atol=1e-12, rtol=0)
    np.testing.assert_allclose(du2.numpy(), kern[2], rtol=1e-12)
    np.testing.assert_allclose(torch.sqrt(du2).sum(0).numpy(), scan[3],
                               rtol=1e-12)


def test_fleet_rollout_cost_matches_jax(jax_rollouts):
    spec, scan, _ = jax_rollouts
    cc = fleet._Consts(spec)
    X, U, cost, du = fleet._rollout(cc, ALPHA, *(torch.as_tensor(a)
                                                 for a in _inputs()))
    np.testing.assert_allclose(X.numpy(), scan[0], atol=1e-12, rtol=0)
    np.testing.assert_allclose(cost.numpy(), scan[2], rtol=1e-12)
    np.testing.assert_allclose(du.numpy(), scan[3], rtol=1e-12)


def test_wrapper_rejects_short_horizon_on_any_device():
    Ks, ds, Xref, Uref, x0 = (torch.as_tensor(a) for a in _inputs(Bl=4))
    with pytest.raises(ValueError, match="H >= 2"):
        rt1.rollout_time1(1.0, Ks[:0], ds[:0], Xref[:1], Uref[:0], x0)


def _meta(n, m, Bl=8, Hs=5, dtype=torch.float32):
    """Arguments on the 'meta' device: not CPU, so the wrapper takes its
    kernel branch, and its checks run without a card."""
    e = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    return (e(Hs - 1, m, n, Bl), e(Hs - 1, m, Bl), e(Hs, n, Bl),
            e(Hs - 1, m, Bl), e(n, Bl))


def test_wrapper_checks_without_a_card():
    """Any chain up to the source's limit passes the width check (and then
    meets the device check); n != m, or a width above the limit, raises
    naming it, before any build."""
    for n in (8, 7, 4, 2):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            rt1.rollout_time1(1.0, *_meta(n, n))
    with pytest.raises(ValueError, match="n = m from 2"):
        rt1.rollout_time1(1.0, *_meta(8, 7))
    for dtype in (torch.float32, torch.float64):
        top = rt1.MAX_N[dtype]
        with pytest.raises(ValueError, match=rf"to {top} in .*Queue 3 F3"):
            rt1.rollout_time1(1.0, *_meta(top + 1, top + 1, dtype=dtype))
    with pytest.raises(TypeError, match="float32/float64"):
        rt1.rollout_time1(1.0, *_meta(8, 8, dtype=torch.float16))
    Ks, *rest = _meta(8, 8)
    with pytest.raises(ValueError, match="more than one device"):
        rt1.rollout_time1(1.0, torch.zeros(Ks.shape), *rest)


def _rel(got, want):
    """Largest error relative to the largest output."""
    return float((got.double() - want).abs().max() / want.abs().max())


# n = dof + 1: the 7-DoF arm, two narrower chains, one chain above the arm,
# and each type's limit
CARD_WIDTHS = sorted({8, 7, 4, 9, *rt1.MAX_N.values()})


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_WIDTHS)
def test_kernel_matches_twin_on_card(n):
    """float64: X, U and ||du||^2 within 1e-9 relative of the twin (the
    correctness gate); float32: error against the float64 twin on the same
    (rounded) inputs within 10x the float32 twin's own, or 1e-6; each type
    up to its `MAX_N`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _inputs(seed=3, Bl=300, n=n)
    for dtype in (torch.float64, torch.float32):
        if n > rt1.MAX_N[dtype]:
            continue
        cuda = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args]
        before = rt1.LAUNCHES
        out = rt1.rollout_time1(0.25, *cuda)
        torch.cuda.synchronize()
        assert rt1.LAUNCHES == before + 1
        ref = rt1.rollout_time1_reference(0.25, *cuda)
        exact = rt1.rollout_time1_reference(0.25, *(a.double() for a in cuda))
        for got, twin, want in zip(out, ref, exact):
            assert bool(torch.isfinite(got).all())
            if dtype == torch.float64:
                assert _rel(got, twin) <= 1e-9
            else:
                assert _rel(got, want) <= max(10 * _rel(twin, want), 1e-6)
