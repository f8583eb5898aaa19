"""Port parity, the parallel-prefix LQR machinery (`ops/pscan.py`), the
linear-quadratic tracker (`solvers/lqt.py`) and `ilqr.solve(backward=
'pscan')`, against the JAX package in float64 on the CPU.

  * `combine_cvf`, `lqr_cost_to_go` and `affine_suffix` on the random
    time-varying inputs of the JAX package's tests/test_pscan.py, at 1e-12
    of the largest output against the JAX functions' own outputs (the port
    copies `jax.lax.associative_scan`'s combination tree); the scan itself
    on every length 1-11, bit for bit;
  * `LQT`: the sequential and parallel DP with `get_command`, and
    `solve_linalg` with `get_command` / `get_predicted_states`, on
    tests/test_lqt.py's double integrator and tests/test_pscan.py's random
    system, at 1e-10 of the largest output;
  * `ilqr.solve(backward='pscan')` against the JAX package's on a posorn
    and a posorn_time problem at H=30 (the JAX test's problems at H=100, cut
    to keep the JAX programs' compile time small): cost rtol 1e-9 and equal
    iterations after 10 iterations; the time-optimal problem also after the
    JAX test's 20, where it has converged (cost 1.6e-8 from 3.08) and the
    kind's amplified rounding moves the final cost by 1.6e-8 relative: there
    iterations equal, U within 1e-9 and the cost within 1e-15 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF
from ilqr_planner_torch.ops import pscan as tp
from ilqr_planner_torch.solvers import ilqr as tilqr
from ilqr_planner_torch.solvers.lqt import LQT as TLQT
from ilqr_planner_torch.utils.convert import spec_like

T1_POS = [0.554121212377707, -0.01575049935289518, 0.38295604872511507]
T1_ORN = [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
          0.022333898196169735]
T2_POS = [0.254121212377707, -0.07575049935289518, 0.13170744424127526]
T2_ORN = [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
          0.00011933313484481926]
QD6 = [1, 1, 1, .1, .1, .1]
Q0 = [0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
      1.50592777, 0.71771416]


def _close(got, want, tol):
    """|got - want| <= tol * max|want| (and the shapes equal)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _ltv_inputs():
    """test_pscan.py's random time-varying system (seed 0, H=23)."""
    rng = np.random.default_rng(0)
    H, nx, nu = 23, 5, 3
    As = rng.normal(size=(H - 1, nx, nx)) * 0.3 + np.eye(nx)
    Bs = rng.normal(size=(H - 1, nx, nu)) * 0.2
    l_x = rng.normal(size=(H - 1, nx))
    l_u = rng.normal(size=(H - 1, nu))
    M = rng.normal(size=(H - 1, nx, nx))
    l_xx = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(nx)
    lN_x = rng.normal(size=nx)
    Mn = rng.normal(size=(nx, nx))
    lN_xx = Mn @ Mn.T + 0.1 * np.eye(nx)
    return As, Bs, l_x, l_u, l_xx, lN_x, lN_xx, np.full(nu, 1e-3)


@pytest.mark.parametrize("n", range(1, 12))
def test_associative_scan_matches_jax_tree(n):
    """The odd/even recursion of jax.lax.associative_scan, forward and
    reverse, over a leading or a second axis: the same values bit for bit
    under a non-commutative combination."""
    x = np.random.default_rng(n).normal(size=(2, n, 3))

    def fn(a, b):
        return (0.5 * a[0] + 1.3 * b[0] * b[0],)

    for reverse in (False, True):
        want = np.asarray(jax.lax.associative_scan(
            fn, (jnp.asarray(x[0]),), reverse=reverse)[0])
        got = tp.associative_scan(fn, (torch.tensor(x[0]),), reverse=reverse)[0]
        assert np.array_equal(got.numpy(), want)
        got2 = tp.associative_scan(fn, (torch.tensor(x),), reverse=reverse,
                                   axis=1)[0]
        assert np.array_equal(got2[0].numpy(), want)


def test_combine_cvf_matches_jax():
    """One combination of two batched elements (C, J symmetric PSD)."""
    from ilqr_planner_tpu.ops.pscan import combine_cvf

    rng = np.random.default_rng(5)
    nx = 5

    def elem():
        A = rng.normal(size=(4, nx, nx))
        b, eta = rng.normal(size=(4, nx)), rng.normal(size=(4, nx))
        C, J = (m @ m.transpose(0, 2, 1) for m in rng.normal(size=(2, 4, nx, nx)))
        return A, b, C, eta, J

    e1, e2 = elem(), elem()
    want = combine_cvf(tuple(map(jnp.asarray, e1)), tuple(map(jnp.asarray, e2)))
    got = tp.combine_cvf(tuple(map(torch.tensor, e1)), tuple(map(torch.tensor, e2)))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_lqr_cost_to_go_matches_jax():
    """test_pscan.py's random LTV inputs, unbatched and with a batch axis
    of 2 in front (the second a copy scaled)."""
    from ilqr_planner_tpu.ops.pscan import lqr_cost_to_go

    args = _ltv_inputs()
    Ps_j, ps_j = lqr_cost_to_go(*map(jnp.asarray, args))
    Ps, ps = tp.lqr_cost_to_go(*map(torch.tensor, args))
    _close(Ps, Ps_j, 1e-12)
    _close(ps, ps_j, 1e-12)
    batched = [torch.tensor(np.stack([a, 2.0 * a])) for a in args[2:7]]
    Ps_b, ps_b = tp.lqr_cost_to_go(torch.tensor(args[0]), torch.tensor(args[1]),
                                   *batched, torch.tensor(args[7]))
    assert torch.equal(Ps_b[0], Ps) and torch.equal(ps_b[0], ps)
    Ps_j2, ps_j2 = lqr_cost_to_go(*map(jnp.asarray, args[:2]),
                                  *(2.0 * jnp.asarray(a) for a in args[2:7]),
                                  jnp.asarray(args[7]))
    _close(Ps_b[1], Ps_j2, 1e-12)
    _close(ps_b[1], ps_j2, 1e-12)


def test_affine_suffix_matches_jax():
    from ilqr_planner_tpu.ops.pscan import affine_suffix

    rng = np.random.default_rng(1)
    T, n = 13, 4
    Ms = rng.normal(size=(T, n, n)) * 0.5
    vs = rng.normal(size=(T, n))
    _close(tp.affine_suffix(torch.tensor(Ms), torch.tensor(vs)),
           affine_suffix(jnp.asarray(Ms), jnp.asarray(vs)), 1e-12)


def _lqt_systems():
    """test_lqt.py's double integrator (N=40, a via-point at 20 and the
    target at 39) and test_pscan.py:149's random system (N=37)."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    N, nx = 40, 2
    Qs = np.zeros((N, nx, nx))
    Qs[-1] = np.eye(nx)
    Qs[N // 2] = np.eye(nx) * 10
    mu = np.zeros(N * nx)
    mu[-nx:] = [1.0, 0.0]
    mu[(N // 2) * nx:(N // 2 + 1) * nx] = [-0.5, 0.0]
    yield "double_integrator", A, B, Qs, mu, 0.01

    rng = np.random.default_rng(3)
    nx, nu, N = 4, 2, 37
    A = np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    B = 0.1 * rng.normal(size=(nx, nu))
    Qs = []
    for k in range(N):
        M = rng.normal(size=(nx, nx)) * (1.0 if k % 9 == 0 else 0.0)
        Qs.append(M @ M.T + (0.5 if k % 9 == 0 else 0.0) * np.eye(nx))
    yield "random", A, B, np.stack(Qs), rng.normal(size=N * nx), 1e-3


@pytest.mark.parametrize("system", ["double_integrator", "random"])
def test_lqt_matches_jax(system):
    """Sequential and parallel DP (value quadratics, feedforward terms and
    the closed-loop command at three steps) and the dense batch solution
    (controls, commands, predicted states) against the JAX LQT."""
    from ilqr_planner_tpu.solvers.lqt import LQT

    _, A, B, Qs, mu, rf = next(s for s in _lqt_systems() if s[0] == system)
    nx, N = A.shape[0], Qs.shape[0]
    x = np.random.default_rng(7).normal(size=nx)
    for parallel in (False, True):
        want, got = LQT(A, B, Qs, mu, rf), TLQT(A, B, Qs, mu, rf, device="cpu")
        want.solve_dp(parallel=parallel)
        got.solve_dp(parallel=parallel)
        _close(got._Ps, want._Ps, 1e-10)
        _close(got._ds, want._ds, 1e-10)
        for t in (0, 7, N - 2):
            _close(got.get_command(t, x), want.get_command(t, x), 1e-10)
    want.solve_linalg()
    got.solve_linalg()
    _close(got._u, want._u, 1e-10)
    _close(got.get_command(3), want.get_command(3), 1e-10)
    _close(got.get_predicted_states(), want.get_predicted_states(), 1e-10)
    with pytest.raises(RuntimeError):
        TLQT(A, B, Qs, mu, rf, device="cpu").get_command(0, x)
    if not torch.cuda.is_available():            # CUDA unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLQT(A, B, Qs, mu, rf)


def _jax_robot():
    from ilqr_planner_tpu.models import Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", "panda_tip", is_path=False,
        dtype=np.float64, prefer_native=False))


@pytest.mark.parametrize("kind", ["posorn", "posorn_time"])
def test_ilqr_pscan_matches_jax(kind):
    """test_pscan.py's golden posorn problem (10 iterations) and its
    time-optimal one (20), at H=30, through both packages' backward='pscan'."""
    from ilqr_planner_tpu.solvers import ilqr as jilqr
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint, SpacetimeKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec

    H = 30
    qmax = np.ones(7) * np.pi * 10
    if kind == "posorn":
        kps = [PosOrnKeypoint(T1_POS, T1_ORN, np.diag(QD6), H // 2 - 1),
               PosOrnKeypoint(T2_POS, T2_ORN, np.diag(QD6), H - 1)]
        spec = make_spec("posorn", _jax_robot(), kps, np.ones(7) * 1e-5, H, 1,
                         dt=0.1, q0=Q0, q_max=qmax, q_min=-qmax)
        U0, nb_iter = np.zeros((H - 1, 7)), 10
    else:
        kps = [SpacetimeKeypoint(T1_POS, T1_ORN, np.diag(QD6 + [0]), H // 2 - 1, 2.0),
               SpacetimeKeypoint(T2_POS, T2_ORN, np.diag(QD6 + [0.1]), H - 1, 5.0)]
        spec = make_spec("posorn_time", _jax_robot(), kps, np.ones(8) * 1e-5, H,
                         1, q0=np.zeros(7), q_max=qmax, q_min=-qmax)
        U0, nb_iter = np.tile([0.0] * 7 + [0.01], (H - 1, 1)), 20
    tspec = spec_like(spec, device="cpu")
    for n in sorted({10, nb_iter}):
        want = jilqr.solve(spec, jnp.asarray(U0), n, backward="pscan")
        got = tilqr.solve(tspec, U0, n, backward="pscan")
        assert int(got.iterations) == int(want.iterations)
        if n == 10:
            np.testing.assert_allclose(float(got.cost), float(want.cost),
                                       rtol=1e-9)
        else:
            # converged to 1.6e-8 from 3.08: the final cost's relative
            # difference (1.6e-8) is rounding, its absolute one (2.5e-16)
            # under float64's resolution of the starting cost
            np.testing.assert_allclose(float(got.cost), float(want.cost),
                                       rtol=0, atol=1e-15)
            np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                                       rtol=0, atol=1e-9)
    scan = tilqr.solve(tspec, U0, nb_iter)
    assert not torch.equal(scan.Ks, got.Ks)      # the other backward pass
