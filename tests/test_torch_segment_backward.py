"""Port parity, the whole-sweep backward: the plain twin of the CUDA kernel
against the JAX Pallas kernel (interpret mode) and against the JAX fleet's
XLA backward, in float64 on the CPU; the wrapper's CPU routing and its
argument checks. The kernel itself runs only on the card (marked `cuda`).

Tolerance 1e-10 absolute on K and d: the same recursion on both sides,
with sums taken in another order.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
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
RT = [1e-5] * 7
DT = 0.1


def _sweep_inputs(n, B, H, kp_steps, seed):
    """Random lane-major sweep inputs, scaled like the flagship's: SPD
    terminal and keypoint Hessians, a positive limit diagonal, so that K
    and d stay O(10)."""
    rng = np.random.default_rng(seed)

    def spd(*lead):
        A = rng.normal(size=lead + (n, n, B))
        return np.einsum("...ikb,...jkb->...ijb", A, A) / n

    L2 = rng.uniform(0.5, 1.5, size=(H - 1, n, B))
    return (spd() + np.eye(n)[:, :, None], rng.normal(size=(n, B)), L2,
            rng.normal(size=(H - 1, n, B)), 0.1 * rng.normal(size=(H - 1, n, B)),
            spd(len(kp_steps)))


def test_twin_matches_pallas_kernel_interpret():
    from ilqr_planner_tpu.ops.pallas_kernels.segment_backward import (
        segment_backward_pallas)

    n, B, H, kp = 7, 128, 6, (2,)
    args = _sweep_inputs(n, B, H, kp, seed=0)
    K_ref, d_ref = segment_backward_pallas(*args, kp, DT, RT, interpret=True)
    K, d = sb.segment_backward_reference(
        *(torch.as_tensor(a) for a in args), kp, DT, RT)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), atol=1e-10, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-10, rtol=0)


def _limit_active_case(H, B, seed):
    """The JAX fleet constants and a random-walk trajectory that crosses
    the q0 +- 0.4 joint limits."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.solvers import fleet as jfleet
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    robot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))
    prec = np.diag([1, 1, 1, .1, .1, .1])
    kps = [PosOrnKeypoint(*T1, prec, H // 2 - 1), PosOrnKeypoint(*T2, prec, H - 1)]
    jspec = jmake_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=DT,
                       q0=Q0, q_max=Q0 + 0.4, q_min=Q0 - 0.4,
                       dtype=np.float64)
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    steps = np.concatenate([q0s[None], 0.05 * rng.normal(size=(H - 1, B, 7))])
    X = np.cumsum(steps, axis=0).transpose(0, 2, 1)        # [H, n, B]
    U = 0.05 * rng.normal(size=(H - 1, 7, B))
    return jfleet, jspec, X, U


def _port_spec(jspec):
    chain = chain_from_urdf(PANDA_URDF, "panda_link0", "panda_tip",
                            device="cpu")
    fields = {k: getattr(jspec, k) for k in
              ("kind", "nb_deriv", "horizon", "limits_set")}
    for k in ("dt", "mu", "prec", "kp_mask", "pos_radius", "orn_thresh", "Rt",
              "state_min", "state_max", "limit_weight", "penalty", "x0", "q0",
              "dq0"):
        fields[k] = np.asarray(getattr(jspec, k))
    return spec_from_arrays(fields, Robot.from_chain(chain), device="cpu")


def test_fleet_backward_matches_jax_xla():
    import jax.numpy as jnp

    H, B = 20, 16
    jfleet, jspec, X, U = _limit_active_case(H, B, seed=0)
    jcc = jfleet._Consts(jspec)
    jcc.backward_impl = "xla"
    K_ref, d_ref = jfleet._backward(jcc, jnp.asarray(X), jnp.asarray(U))
    Lq, _ = jfleet._limit_arrays(jcc, jnp.asarray(X))
    assert float(jnp.abs(Lq).max()) > 0.01       # the limits are live

    cc = fleet._Consts(_port_spec(jspec))
    before = sb.LAUNCHES
    K, d = fleet._backward(cc, torch.as_tensor(X), torch.as_tensor(U))
    assert sb.LAUNCHES == before
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), atol=1e-10, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-10, rtol=0)


def test_wrapper_on_cpu_runs_twin_without_launch():
    args = [torch.as_tensor(a) for a in _sweep_inputs(7, 16, 5, (1, 3), seed=1)]
    before = sb.LAUNCHES
    K, d = sb.segment_backward(*args, (1, 3), DT, RT)
    K_ref, d_ref = sb.segment_backward_reference(*args, (1, 3), DT, RT)
    assert sb.LAUNCHES == before == 0
    assert torch.equal(K, K_ref) and torch.equal(d, d_ref)
    assert K.shape == (4, 7, 7, 16) and d.shape == (4, 7, 16)


def _meta(n, B=8, H=5, n_kp=1, dtype=torch.float32):
    """Arguments on the 'meta' device: not CPU, so the wrapper takes its
    kernel branch, and its checks run without a card."""
    e = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    return (e(n, n, B), e(n, B), e(H - 1, n, B), e(H - 1, n, B),
            e(H - 1, n, B), e(n_kp, n, n, B))


def test_wrapper_rejects_other_widths_without_a_card():
    """Any chain up to the source's limit passes the width check (and then
    meets the device check); a chain above it raises naming the limit,
    before any build."""
    for n in (7, 6, 3, 1):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            sb.segment_backward(*_meta(n), (2,), DT, [1e-5] * n)
    for dtype in (torch.float32, torch.float64):
        top = sb.MAX_N[dtype]
        with pytest.raises(ValueError, match=rf"n <= {top} joints.*Queue 3 F3"):
            sb.segment_backward(*_meta(top + 1, dtype=dtype), (2,), DT,
                                [1e-5] * (top + 1))


def test_wrapper_rejects_non_cuda_and_bad_shapes():
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sb.segment_backward(*_meta(7), (2,), DT, RT)
    with pytest.raises(TypeError, match="float32/float64"):
        sb.segment_backward(*_meta(7, dtype=torch.float16), (2,), DT, RT)


def _rel(got, want):
    """Largest error relative to the largest output."""
    return float((got.double() - want).abs().max() / want.abs().max())


# the 7-DoF arm, two narrower chains, one chain above the arm, and each
# type's limit
CARD_WIDTHS = sorted({7, 6, 3, 8, *sb.MAX_N.values()})


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_WIDTHS)
def test_kernel_matches_twin_on_card(n):
    """float64: relative error <= 1e-9 (the correctness gate); float32:
    error against the float64 twin on the same (rounded) inputs within 10x
    the float32 twin's own, or 1e-6; each type up to its `MAX_N`; a ragged
    last block, keypoints at the first and the last step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = (0, 7)
    Rt = [1e-5] * n
    args = _sweep_inputs(n, 300, 9, kp, seed=2)
    for dtype in (torch.float64, torch.float32):
        if n > sb.MAX_N[dtype]:
            continue
        cuda = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args]
        before = sb.LAUNCHES
        K, d = sb.segment_backward(*cuda, kp, DT, Rt)
        torch.cuda.synchronize()
        assert sb.LAUNCHES == before + 1
        assert bool(torch.isfinite(K).all()) and bool(torch.isfinite(d).all())
        K_ref, d_ref = sb.segment_backward_reference(*cuda, kp, DT, Rt)
        if dtype == torch.float64:
            for got, ref in ((K, K_ref), (d, d_ref)):
                assert _rel(got, ref) <= 1e-9
        else:
            exact = sb.segment_backward_reference(*(a.double() for a in cuda),
                                                  kp, DT, Rt)
            for got, twin, ref in zip((K, d), (K_ref, d_ref), exact):
                assert _rel(got, ref) <= max(10 * _rel(twin, ref), 1e-6)
