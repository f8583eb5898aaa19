"""Port parity, the fused dense quadratization + Riccati sweep: the plain
twin of the CUDA kernel against the JAX package's plain reference, against
its Pallas kernel in interpret mode, and against the port's own generic
recursion (`ilqr._backward_core`) on a real Panda spec, in float64 on the
CPU; `ops.linalg.solve_spd` against the JAX one; the wrapper's CPU routing
and its argument checks. The kernel itself runs only on the card (marked
`cuda`).

Tolerances: twin vs JAX reference 1e-9 absolute (explicit Gauss-Jordan
inverse against LU, gains up to ~10); twin vs Pallas interpret rtol 1e-10
(the same elimination, sums in another order); twin vs the generic route
1e-9 absolute (one augmented solve against the explicit inverse);
solve_spd 1e-12.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops import linalg
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
N, NQ, DT = 7, 6, 0.1
RT = [1e-5] * N


# the residual precisions of the built widths: position + orientation,
# joint, point
PREC_DIAG = {6: [1, 1, 1, .1, .1, .1], 7: [1] * 7, 3: [1, 1, 1]}


def _random_inputs(B, H, seed=0, dense_prec=False, weight=1.0, limit_frac=0.2,
                   nq=NQ, n=N):
    """Kernel inputs as numpy arrays: Jacobians and residuals at every step,
    a live limit penalty on a share `limit_frac` of the entries, precisions
    (scaled by `weight`) at two steps (or at every step)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, H, nq, n)) * 0.3
    e = rng.normal(size=(B, H, nq)) * 0.05
    ld = (rng.uniform(size=(B, H, n)) < limit_frac).astype(float)
    lq = ld * rng.normal(size=(B, H, n)) * 0.1
    u = rng.normal(size=(B, H - 1, n)) * 0.1
    prec = np.zeros((H, nq, nq))
    steps = range(H) if dense_prec else (H // 2, H - 1)
    for k in steps:
        prec[k] = weight * np.diag(PREC_DIAG.get(nq, [1.0] * nq))
    return J, e, ld, lq, u, prec


def _twin(args):
    K, d = ric.riccati_backward_reference(*(torch.as_tensor(a) for a in args),
                                          RT, DT)
    return K.numpy(), d.numpy()


@pytest.mark.parametrize("dense_prec", [False, True], ids=["kp_sparse", "dense"])
def test_twin_matches_jax_reference(dense_prec):
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_reference as jref)

    args = _random_inputs(4, 12, seed=1, dense_prec=dense_prec)
    K_ref, d_ref = jref(*(jnp.asarray(a) for a in args), np.asarray(RT), DT)
    K, d = _twin(args)
    assert K.shape == (4, 11, N, N) and d.shape == (4, 11, N)
    np.testing.assert_allclose(K, np.asarray(K_ref), atol=1e-9, rtol=0)
    np.testing.assert_allclose(d, np.asarray(d_ref), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dense_prec,weight", [(False, 1.0), (True, 1e-4)],
                         ids=["kp_sparse", "dense_low_weight"])
def test_twin_matches_jax_reference_at_full_horizon(dense_prec, weight):
    """H = 100, the solver paths' horizon, with inputs scaled like a solve's:
    the limit penalty live on 0.5% of the entries, and the every-step
    precisions at weight 1e-4. Tolerance 1e-9 relative to the largest gain.
    While a = dt^2 P dominates r = Rt the recursion, as the twin writes it
    after the JAX reference, grows the antisymmetric rounding residue A of P by A' = A (1 + (a /
    (a + r))^2) a step, up to doubling it; the steps after a keypoint or an
    active limit are such steps. So over 100 steps two orders of the same
    sums drift apart by more than at H = 12; a limit penalty live on 20% of
    the entries, or unit precisions at every step, take the difference to
    1e-5 and, in the port's twin, to overflow in float64
    (`python3 tools/riccati_rounding.py` prints the table)."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_reference as jref)

    args = _random_inputs(2, 100, seed=7, dense_prec=dense_prec, weight=weight,
                          limit_frac=0.005)
    K_ref, d_ref = (np.asarray(a) for a in jref(
        *(jnp.asarray(a) for a in args), np.asarray(RT), DT))
    K, d = _twin(args)
    assert np.isfinite(K).all() and np.isfinite(d).all()
    assert np.abs(K - K_ref).max() <= 1e-9 * np.abs(K_ref).max()
    assert np.abs(d - d_ref).max() <= 1e-9 * np.abs(d_ref).max()


@pytest.mark.parametrize("nq", [7, 3], ids=["joint_nq7", "point_nq3"])
@pytest.mark.parametrize("dense_prec", [False, True], ids=["kp_sparse", "dense"])
def test_twin_matches_jax_reference_at_other_widths(nq, dense_prec):
    """The joint (nq = 7) and point (nq = 3) residual widths, which the
    kernel is also built for; tolerance as at nq = 6."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_reference as jref)

    args = _random_inputs(4, 12, seed=8, dense_prec=dense_prec, nq=nq)
    K_ref, d_ref = jref(*(jnp.asarray(a) for a in args), np.asarray(RT), DT)
    K, d = _twin(args)
    assert K.shape == (4, 11, N, N) and d.shape == (4, 11, N)
    np.testing.assert_allclose(K, np.asarray(K_ref), atol=1e-9, rtol=0)
    np.testing.assert_allclose(d, np.asarray(d_ref), atol=1e-9, rtol=0)


def test_twin_matches_pallas_interpret():
    """One (1, 128) lane tile of the TPU kernel in interpret mode, float64."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.pallas_kernels.riccati import (
        riccati_backward_structured)

    args = _random_inputs(128, 5, seed=2)
    K_pl, d_pl = riccati_backward_structured(
        *(jnp.asarray(a) for a in args), np.asarray(RT), DT, lane_sublanes=1,
        interpret=True)
    K, d = _twin(args)
    np.testing.assert_allclose(K, np.asarray(K_pl), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d, np.asarray(d_pl), rtol=1e-10, atol=1e-12)


def test_twin_matches_generic_route_on_panda_spec():
    """The A = I, B = dt I specialization against the port's generic
    recursion with the spec's constant A, B, on rolled-out Panda states with
    the limit penalty live."""
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    H, B = 12, 3
    prec = np.diag([1, 1, 1, .1, .1, .1])
    kps = [kps_mod.PosOrnKeypoint(*T1, prec, 5),
           kps_mod.PosOrnKeypoint(*T1, prec, H - 1)]
    spec = make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=DT,
                     q0=Q0, q_max=Q0 + 0.05, q_min=Q0 - 0.05, device="cpu")
    rng = np.random.default_rng(3)
    U = torch.as_tensor(rng.normal(size=(B, H - 1, 7)) * 0.1)
    zK, zd = U.new_zeros(B, H - 1, 7, 7), U.new_zeros(B, H - 1, 7)
    X, fX, U, As, Bs, Js, _, _ = ilqr.rollout(spec, 0.0, zK, zd,
                                              U.new_zeros(B, H, 7), U)
    assert bool((funcs.limit_terms(spec, X)[0] != 0).any())
    before = ric.LAUNCHES
    K, d = ilqr._backward(spec, X, fX, U, As, Bs, Js)   # the riccati route
    assert ric.LAUNCHES == before                       # the CPU runs the twin
    ks = torch.arange(H)
    U_pad = torch.cat([U, torch.zeros_like(U[:, :1])], dim=1)
    l_x, l_u, l_xx = funcs.cost_gradients(spec, X, fX, Js, U_pad, ks)
    K_g, d_g = ilqr._backward_core(spec, As, Bs, l_x[:, :-1], l_u[:, :-1],
                                   l_xx[:, :-1], l_x[:, -1], l_xx[:, -1])
    np.testing.assert_allclose(K.numpy(), K_g.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(d.numpy(), d_g.numpy(), atol=1e-9, rtol=0)


@pytest.mark.parametrize("vec", [False, True], ids=["matrix", "vector"])
def test_solve_spd_matches_jax(vec):
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops.linalg import solve_spd as jsolve

    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 7, 7))
    A = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(7)
    Bm = rng.normal(size=(5, 7) if vec else (5, 7, 8))
    ref = np.asarray(jsolve(jnp.asarray(A), jnp.asarray(Bm)))
    got = linalg.solve_spd(torch.as_tensor(A), torch.as_tensor(Bm)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=1e-12)


def test_wrapper_runs_twin_on_cpu_for_any_batch():
    """CPU tensors run the twin, at a batch that is no multiple of 128."""
    args = [torch.as_tensor(a) for a in _random_inputs(5, 4, seed=5)]
    before = ric.LAUNCHES
    K, d = ric.riccati_backward(*args, RT, DT)
    assert ric.LAUNCHES == before
    K_ref, d_ref = ric.riccati_backward_reference(*args, RT, DT)
    assert torch.equal(K, K_ref) and torch.equal(d, d_ref)
    with pytest.raises(ValueError, match="H >= 2"):
        ric.riccati_backward(*(a[:, :1] for a in args[:4]), args[4][:, :0],
                             args[5][:1], RT, DT)


def _meta(n=N, nq=NQ, B=8, H=5, dtype=torch.float32):
    """Arguments on the 'meta' device: not CPU, so the wrapper takes its
    kernel branch, and its checks run without a card."""
    e = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    return [e(B, H, nq, n), e(B, H, nq), e(B, H, n), e(B, H, n),
            e(B, H - 1, n), e(H, nq, nq)]


def test_wrapper_checks_without_a_card():
    """Any chain up to the source's limit, at the kinds' residual widths,
    passes the width checks (and then meets the device check); another
    residual width, or a chain above the limit, raises naming it, before
    any build."""
    for n, nq in ((7, 6), (7, 7), (7, 3), (6, 6), (6, 3), (3, 3), (8, 8), (1, 6),
                  (7, 12), (7, 13), (3, 2), (7, 4)):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            ric.riccati_backward(*_meta(n=n, nq=nq), [1e-5] * n, DT)
    for dtype in (torch.float32, torch.float64):
        top = ric.MAX_NQ[dtype]
        with pytest.raises(ValueError, match=rf"nq <= {top} in"):
            ric.riccati_backward(*_meta(nq=top + 1, dtype=dtype), RT, DT)
    for dtype in (torch.float32, torch.float64):
        top = ric.MAX_N[dtype]
        with pytest.raises(ValueError, match=rf"n <= {top} joints.*Queue 3 F3"):
            ric.riccati_backward(*_meta(n=top + 1, dtype=dtype), [1e-5] * (top + 1),
                                 DT)
    with pytest.raises(TypeError, match="float32/float64"):
        ric.riccati_backward(*_meta(dtype=torch.float16), RT, DT)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ric.riccati_backward(*_meta(), RT, DT)
    J, *rest = _meta()
    with pytest.raises(ValueError, match="more than one device"):
        ric.riccati_backward(torch.zeros(J.shape), *rest, RT, DT)


def _rel(got, want):
    """Largest error relative to the largest output."""
    return float((got.double() - want).abs().max() / want.abs().max())


# the arm's and narrower chains' widths, then one chain above the arm and
# each type's limit at every residual width (posorn, joint, point)
CARD_CASES = [(7, 6), (7, 7), (7, 3), (6, 6), (6, 3), (3, 3)] + [
    (n, nq) for n in sorted({8, *ric.MAX_N.values()}) if n > N
    for nq in ric.residual_widths(n)] + [
    # sequential specs' widths (two posorn subsystems; joint + posorn), the
    # planar point's, and each type's widest residual
    (7, 12), (7, 13), (3, 2)] + sorted({
        (ric.MAX_N[t], ric.MAX_NQ[t]) for t in (torch.float32, torch.float64)})


@pytest.mark.cuda
@pytest.mark.parametrize("n,nq", CARD_CASES)
def test_kernel_matches_twin_on_card(n, nq):
    """float64: K and d within 1e-9 relative of the twin (the correctness
    gate), at a batch that leaves the last block ragged, with the precision
    at two steps and at every step, and on a horizon that is no multiple of
    the staged chunk; float32: error against the float64 twin on the same
    (rounded) inputs within 10x the float32 twin's own, or 1e-6; each type
    up to its `MAX_N` and `MAX_NQ`. At nq = 6 the limit penalty is live
    on 20% of the entries and the every-step precisions have unit weight;
    at the other widths and on the short horizon the inputs are scaled like
    a solve's: limits live on 0.5% of the entries, every-step weight 1e-4.
    (Every live limit, and a unit precision at every step, amplify the
    recursion's rounding; at the joint width's full-rank precision, unit
    weight at every step puts two orders of the same sums 1.5e-10 apart at
    H = 20 on the CPU: `tools/riccati_rounding.py`.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    limit_frac, dense_weight = ((0.2, 1.0) if (n, nq) == (N, NQ)
                                else (0.005, 1e-4))
    Rt = [1e-5] * n
    cases = [_random_inputs(300, 20, seed=6, dense_prec=dense_prec, nq=nq, n=n,
                            limit_frac=limit_frac,
                            weight=dense_weight if dense_prec else 1.0)
             for dense_prec in (False, True)]
    cases.append(_random_inputs(45, 13, seed=9, nq=nq, n=n, limit_frac=0.005))
    for args in cases:
        for dtype in (torch.float64, torch.float32):
            if n > ric.MAX_N[dtype] or nq > ric.MAX_NQ[dtype]:
                continue
            cuda = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args]
            before = ric.LAUNCHES
            out = ric.riccati_backward(*cuda, Rt, DT)
            torch.cuda.synchronize()
            assert ric.LAUNCHES == before + 1
            ref = ric.riccati_backward_reference(*cuda, Rt, DT)
            exact = ric.riccati_backward_reference(*(a.double() for a in cuda),
                                                   Rt, DT)
            for got, twin, want in zip(out, ref, exact):
                assert bool(torch.isfinite(got).all())
                if dtype == torch.float64:
                    assert _rel(got, twin) <= 1e-9
                else:
                    assert _rel(got, want) <= max(10 * _rel(twin, want), 1e-6)
