"""Port parity, the double-integrator and time-optimal whole-sweep backward:
the plain twin of the CUDA kernel (through the port's fleet `_backward`)
against the JAX fleet's XLA backward and against the JAX Pallas kernels in
interpret mode, in float64 on the CPU; the wrappers' CPU routing and their
argument checks. The kernel itself runs only on the card (marked `cuda`).

Tolerance 1e-10 absolute on K and d: the same recursion and the same
Gauss-Jordan elimination order on both sides, with sums taken in another
order.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
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
B = 128
KINDS = ("second", "time1")


def _jax_case(kind):
    """The JAX fleet constants and a random-walk trajectory: for 'second'
    the double integrator with an inner and a terminal keypoint (12 x 12
    precisions, zero velocity targets); for 'time1' the sqrt-dt kind with
    two spacetime keypoints, joint limits q0 +- 0.4 live, and the step
    control s kept away from zero."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.solvers import fleet as jfleet
    from ilqr_planner_tpu.systems.keypoints import (PosOrnKeypoint,
                                                    SpacetimeKeypoint)
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    robot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    if kind == "second":
        H = 10
        qd = np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0])
        kps = [PosOrnKeypoint(*T, qd, k, dposition=[0, 0, 0],
                              dorientation=[0, 0, 0, 0])
               for T, k in ((T1, H // 2), (T2, H - 1))]
        qmax = np.ones(7) * np.pi * 10
        jspec = jmake_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 2,
                           dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax,
                           dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10,
                           dtype=np.float64)
        rng = np.random.default_rng(5)
        x0 = np.concatenate([Q0[None] + 0.05 * rng.normal(size=(B, 7)),
                             0.1 * rng.normal(size=(B, 7))], axis=-1)
        steps = np.concatenate([x0[None], 0.01 * rng.normal(size=(H - 1, B, 14))])
        U = 0.05 * rng.normal(size=(H - 1, 7, B))
    else:
        H = 12
        kps = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]),
                                 H // 2, 2.0),
               SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, 0.1]),
                                 H - 1, 5.0)]
        jspec = jmake_spec("posorn_time", robot, kps, np.ones(8) * 1e-5, H, 1,
                           dt=None, q0=Q0, q_max=Q0 + 0.4, q_min=Q0 - 0.4,
                           dtype=np.float64)
        rng = np.random.default_rng(7)
        x0 = np.concatenate([Q0[None] + 0.05 * rng.normal(size=(B, 7)),
                             np.zeros((B, 1))], axis=-1)
        steps = np.concatenate([x0[None], 0.1 * rng.normal(size=(H - 1, B, 8))])
        U = 0.05 * rng.normal(size=(H - 1, 8, B))
        U[:, -1] = 0.1 + 0.05 * np.abs(U[:, -1])
    X = np.cumsum(steps, axis=0).transpose(0, 2, 1)        # [H, n, B]
    return jfleet, jspec, X, U


def _port_consts(jspec):
    chain = chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip",
                            device="cpu")
    fields = {k: getattr(jspec, k) for k in
              ("kind", "nb_deriv", "horizon", "limits_set")}
    for k in ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
              "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
              "dq0"):
        fields[k] = np.asarray(getattr(jspec, k))
    return fleet._Consts(spec_from_arrays(fields, Robot.from_chain(chain),
                                          device="cpu"))


@pytest.fixture(scope="module", params=KINDS)
def sweep_case(request):
    """(kind, port K/d, JAX XLA K/d, JAX Pallas-interpret K/d) on one case."""
    import jax.numpy as jnp

    jfleet, jspec, X, U = _jax_case(request.param)
    jcc = jfleet._Consts(jspec)
    out = {}
    for impl in ("xla", "pallas_interpret"):
        jcc.backward_impl = impl
        out[impl] = jfleet._backward(jcc, jnp.asarray(X), jnp.asarray(U))
    if request.param == "time1":
        Lq, _ = jfleet._limit_arrays(jcc, jnp.asarray(X))
        assert float(jnp.abs(Lq).max()) > 0.01       # the limits are live
    before = dict(sb2.LAUNCHES)
    got = fleet._backward(_port_consts(jspec), torch.as_tensor(X),
                          torch.as_tensor(U))
    assert sb2.LAUNCHES == before                    # the CPU runs the twin
    return request.param, got, out


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_sweep_twin_matches_jax(sweep_case, impl):
    kind, (K, d), ref = sweep_case
    K_ref, d_ref = (np.asarray(a) for a in ref[impl])
    n, m = sb2.widths(kind, 7)
    assert K.shape == (K_ref.shape[0], m, n, B) == K_ref.shape
    np.testing.assert_allclose(K.numpy(), K_ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-10, rtol=0)


def _sweep_inputs(n, m, Bl, H, kp_steps, seed):
    """Random lane-major sweep inputs scaled like a solve's: SPD terminal
    and keypoint Hessians, a positive limit diagonal, and for 'time1'
    (n == m) step controls s away from zero."""
    rng = np.random.default_rng(seed)

    def spd(*lead):
        A = rng.normal(size=lead + (n, n, Bl))
        return np.einsum("...ikb,...jkb->...ijb", A, A) / n

    U = 0.1 * rng.normal(size=(H - 1, m, Bl))
    if n == m:
        U[:, -1] = 0.1 + 0.05 * np.abs(U[:, -1])
    return (spd() + np.eye(n)[:, :, None], rng.normal(size=(n, Bl)),
            rng.uniform(0.5, 1.5, size=(H - 1, n, Bl)),
            rng.normal(size=(H - 1, n, Bl)), U, spd(len(kp_steps)))


def _call(kind, args, kp, fn=None):
    Rt = [1e-5] * args[4].shape[1]
    if kind == "second":
        return (fn or sb2.segment_backward_2nd)(*args, kp, 0.01, Rt)
    return (fn or sb2.segment_backward_time1)(*args, kp, Rt)


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_on_cpu_runs_twin_without_launch(kind):
    n, m = sb2.widths(kind, 7)
    args = [torch.as_tensor(a) for a in _sweep_inputs(n, m, 16, 5, (1, 3), 1)]
    before = dict(sb2.LAUNCHES)
    K, d = _call(kind, args, (1, 3))
    K_ref, d_ref = sb2.segment_backward_2nd_reference(
        kind, *args, (1, 3), 0.01 if kind == "second" else None,
        [1e-5] * m)
    assert sb2.LAUNCHES == before
    assert torch.equal(K, K_ref) and torch.equal(d, d_ref)
    assert K.shape == (4, m, n, 16) and d.shape == (4, m, 16)


def _meta(n, m, Bl=8, H=5, n_kp=1, dtype=torch.float32):
    """Arguments on the 'meta' device: not CPU, so the wrapper takes its
    kernel branch, and its checks run without a card."""
    e = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    return (e(n, n, Bl), e(n, Bl), e(H - 1, n, Bl), e(H - 1, n, Bl),
            e(H - 1, m, Bl), e(n_kp, n, n, Bl))


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_checks_without_a_card(kind):
    """Any chain up to the source's limit passes the width check (and then
    meets the device check); widths that are not the kind's, or above the
    limit, raise naming it, before any build."""
    n, m = sb2.widths(kind, 7)
    with pytest.raises(ValueError, match=r"takes \(n, m\)"):
        _call(kind, _meta(n - 1, m), (2,))
    for dof in (7, 6, 3, 1):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            _call(kind, _meta(*sb2.widths(kind, dof)), (2,))
    for dtype in (torch.float32, torch.float64):
        top = sb2.MAX_DOF[kind][dtype]
        with pytest.raises(ValueError, match=rf"dof <= {top} joints.*Queue 3 F3"):
            _call(kind, _meta(*sb2.widths(kind, top + 1), dtype=dtype), (2,))
    with pytest.raises(TypeError, match="float32/float64"):
        _call(kind, _meta(n, m, dtype=torch.float16), (2,))
    mixed = [torch.zeros(a.shape, dtype=a.dtype) if i == 0 else a
             for i, a in enumerate(_meta(n, m))]     # P0 on the CPU
    with pytest.raises(ValueError, match="more than one device"):
        _call(kind, mixed, (2,))


def _rel(got, want):
    """Largest error relative to the largest output."""
    return float((got.double() - want).abs().max() / want.abs().max())


# each kind at the 7-DoF arm, two narrower chains, one chain above the arm,
# and each type's limit
CARD_CASES = [(kind, dof) for kind in KINDS
              for dof in sorted({7, 6, 3, 8, *sb2.MAX_DOF[kind].values()})]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dof", CARD_CASES)
def test_kernel_matches_twin_on_card(kind, dof):
    """float64: relative error <= 1e-9 (the correctness gate); float32:
    error against the float64 twin on the same (rounded) inputs within 10x
    the float32 twin's own, or 1e-6; each type up to its `MAX_DOF`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, m = sb2.widths(kind, dof)
    kp = (2, 5)
    dt = 0.01 if kind == "second" else None
    args = _sweep_inputs(n, m, 300, 9, kp, seed=2)
    for dtype in (torch.float64, torch.float32):
        if dof > sb2.MAX_DOF[kind][dtype]:
            continue
        cuda = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args]
        before = sb2.LAUNCHES[kind]
        K, d = _call(kind, cuda, kp)
        torch.cuda.synchronize()
        assert sb2.LAUNCHES[kind] == before + 1
        assert bool(torch.isfinite(K).all()) and bool(torch.isfinite(d).all())
        K_ref, d_ref = sb2.segment_backward_2nd_reference(kind, *cuda, kp, dt,
                                                          [1e-5] * m)
        if dtype == torch.float64:
            for got, ref in ((K, K_ref), (d, d_ref)):
                assert _rel(got, ref) <= 1e-9
        else:
            exact = sb2.segment_backward_2nd_reference(
                kind, *(a.double() for a in cuda), kp, dt, [1e-5] * m)
            for got, twin, ref in zip((K, d), (K_ref, d_ref), exact):
                assert _rel(got, ref) <= max(10 * _rel(twin, ref), 1e-6)
