"""The joint-limit penalty kernel's twins and its call sites in the fleet
solver, on the CPU; the kernel against its twins on the card (marked
`cuda`).

On the CPU the fleet runs the twins, which are the penalty math the fleet
ran before the kernel (kept below as `_old_*`, with the old line-search
trial's stage terms, which formed the trial trajectory Xa, patched in for
the fleet's own where a walk or a whole solve runs them): every check here
is bit for bit. On the card the arrays form (lx, L2) is bit for bit too; the cost
differs from the twin's only in the order of a lane's sum of N = H n nsub
non-negative terms, and any two orders of such a sum agree within
2 (N - 1) u of it (u the unit roundoff, eps = 2u): the cost is held to
N eps relative, its zeros, infs and NaNs exactly. No JAX here: the card
tests run on a machine without it.
"""

import types

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import limit_penalty as lp
from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
from ilqr_planner_torch.solvers import fleet
from ilqr_planner_torch.systems.keypoints import (AngularKeypoint,
                                                  PosOrnKeypoint,
                                                  SpacetimeKeypoint)
from ilqr_planner_torch.systems.spec import (_limit_arrays, make_spec,
                                             sequential_spec)

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
PREC = np.diag([1, 1, 1, .1, .1, .1])
DTYPES = {"f32": torch.float32, "f64": torch.float64}


# ---------------------------------------------------------------------------
# the fleet's penalty path before the kernel
# ---------------------------------------------------------------------------

def _old_terms(sc, X):
    smax, smin = sc.smax[:, None], sc.smin[:, None]
    over = X > smax
    under = X < smin
    active = (sc.weight[:, None] != 0) & (over | under)
    zero = torch.zeros_like(X)
    Ld = torch.where(active, torch.full_like(X, sc.penalty), zero)
    ql = torch.where(over, smax - X, torch.where(under, smin - X, zero))
    return Ld, torch.where(active, ql, zero)


def _old_arrays(cc, X):
    Lq = torch.zeros_like(X)
    L2 = torch.zeros_like(X)
    for sc in cc.subs:
        if sc.limits_set:
            Ld, ql = _old_terms(sc, X)
            Lq = Lq + Ld * ql
            L2 = L2 + Ld * Ld
    return Lq, L2


def _old_cost_full(cc, X):
    cost = torch.zeros_like(X[0, 0])
    for sc in cc.subs:
        if sc.limits_set:
            Ld, ql = _old_terms(sc, X)
            cost = cost + (Ld * ql * ql).sum((0, 1))
    return cost


def _old_limit_cost_full(cc, X, Xd=None, alpha=0.0):
    return _old_cost_full(cc, X if Xd is None else X + alpha * Xd)


def _old_kp_cost(cc, X, U, cost, Xd=None, Ud=None, alpha=0.0, kpa=None):
    Xa = X if Xd is None else X + alpha * Xd
    for k in cc.kp_steps:
        if k < cc.H - 1:
            uk = U[k] if Ud is None else U[k] + alpha * Ud[k]
            for i_sub, _ in cc.kp_at[k]:
                cost = cost + (cc.subs[i_sub].Rt[:, None] * uk * uk).sum(0)
        kc, _, _ = fleet._kp_terms_at(cc, k, Xa[k], False, kpa)
        cost = cost + kc
    return cost


def _patch_old_stage_terms(m):
    """Patch the old penalty functions and the old Xa trial's terms in for
    the fleet's stage terms (monkeypatch context `m`)."""
    m.setattr(fleet, "_limit_arrays",
              lambda cc, X: tuple(f(t) for f, t in zip(
                  (torch.neg, lambda t: t), _old_arrays(cc, X))))
    m.setattr(fleet, "_limit_cost_full", _old_limit_cost_full)
    m.setattr(fleet, "_kp_cost", _old_kp_cost)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _bits(t):
    t = t.contiguous()
    if t.is_floating_point():
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
    return t


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a).cpu(), _bits(b).cpu()))


def _sub(limits, dtype, device):
    """A subsystem's limit constants as the fleet keeps them (`_SubC`)."""
    _, smax, smin, weight, penalty = limits
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return types.SimpleNamespace(limits_set=True, smax=t(smax), smin=t(smin),
                                 weight=t(weight), penalty=float(penalty))


def _limit_case(case):
    """-> (list of `spec._limit_arrays` results, n): the limit tables of the
    spec kinds (first order, the time kinds' zero-weight time slot, second
    order with velocity limits, or with the velocity block masked; two
    limited subsystems of a sequential spec)."""
    q = np.linspace(0.3, 0.9, 7)
    if case == "first":
        return [_limit_arrays(7, 1, q, -q, None, None, False, np.float64)], 7
    if case == "time_slot":
        return [_limit_arrays(7, 1, q, -q, None, None, True, np.float64)], 8
    if case == "velocity":
        return [_limit_arrays(7, 2, q, -q, 0.5 * q, -0.5 * q, False,
                              np.float64)], 14
    if case == "velocity_masked":
        return [_limit_arrays(7, 2, q, -q, None, None, False, np.float64)], 14
    assert case == "sequential"
    return [_limit_arrays(7, 1, q, -q, None, None, False, np.float64),
            _limit_arrays(7, 1, 0.8 * q, -1.2 * q, None, None, False,
                          np.float64)], 7


CASES = ("first", "time_slot", "velocity", "velocity_masked", "sequential")


def _trajectory(H, n, B, dtype, seed, device="cpu", scale=0.8):
    """(Xb, Xd): the base and direction of an affine family, views of one
    [H, 2, n, B] array as the fleet holds them, with NaN and +-inf entries
    in both; about half of the entries lie outside the limits."""
    g = torch.Generator().manual_seed(seed)
    Xbd = scale * torch.randn((H, 2, n, B), generator=g, dtype=torch.float64)
    Xbd[0, 0, 0, 0] = float("nan")
    Xbd[1 % H, 0, 1, B - 1] = float("inf")
    Xbd[H - 1, 0, n - 1, B // 2] = -float("inf")
    Xbd[H - 1, 1, 0, 0] = float("inf")
    Xbd[0, 1, n - 1, B - 1] = float("nan")
    Xbd = Xbd.to(dtype=dtype, device=device)
    return Xbd[:, 0], Xbd[:, 1]


def _consts(case, dtype, device="cpu"):
    limits, n = _limit_case(case)
    subs = [_sub(lim, dtype, device) for lim in limits]
    return types.SimpleNamespace(subs=subs,
                                 limit_table=fleet._limit_table(subs)), n


# ---------------------------------------------------------------------------
# the twins and the fleet's wrappers against the old math (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_twins_equal_the_old_penalty_math(case, dtype):
    """`limit_cost` (plain and affine) and `limit_arrays` on CPU tensors, and
    the fleet's `_limit_cost_full` / `_limit_arrays` over them, give the old
    `_limit_terms` math's bits, NaN and inf entries included; the table
    keeps each subsystem's rows in order; no kernel launch is counted."""
    dt = DTYPES[dtype]
    cc, n = _consts(case, dt)
    assert cc.limit_table.shape == (len(cc.subs), 4, n)
    Xb, Xd = _trajectory(6, n, 37, dt, seed=len(case))
    before = dict(lp.LAUNCHES)
    Lq, L2 = _old_arrays(cc, Xb)
    assert bool((L2 != 0).any()) and bool((L2 == 0).any())
    for lx_new, L2_new in (lp.limit_arrays(Xb, table=cc.limit_table),
                           fleet._limit_arrays(cc, Xb)):
        assert _same_bits(lx_new, -Lq) and _same_bits(L2_new, L2)
    for a in (1.0, 0.25, 2.0 ** -10):
        want = _old_cost_full(cc, Xb + a * Xd)
        assert _same_bits(lp.limit_cost(Xb, Xd, a, table=cc.limit_table), want)
        assert _same_bits(fleet._limit_cost_full(cc, Xb, Xd, a), want)
    want = _old_cost_full(cc, Xb)
    assert torch.isinf(want).any()
    assert _same_bits(lp.limit_cost(Xb, table=cc.limit_table), want)
    assert _same_bits(fleet._limit_cost_full(cc, Xb), want)
    assert lp.LAUNCHES == before


def test_no_limits_gives_zeros_and_no_table():
    """A spec without limits has no table; the fleet's penalty is zero,
    lx the old -0 rows, and no kernel is called."""
    sub = types.SimpleNamespace(limits_set=False)
    cc = types.SimpleNamespace(subs=[sub], limit_table=fleet._limit_table([sub]))
    assert cc.limit_table is None
    X = torch.randn(5, 7, 9, dtype=torch.float64)
    lx, L2 = fleet._limit_arrays(cc, X)
    assert _same_bits(lx, -torch.zeros_like(X)) and _same_bits(L2, torch.zeros_like(X))
    assert _same_bits(fleet._limit_cost_full(cc, X), torch.zeros(9, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the fleet's trial and whole solves against the old path (CPU)
# ---------------------------------------------------------------------------

H, B, NB_ITER = 20, 8, 6
LIM = 0.05   # joint limits q0 +- LIM: the penalty binds along the solve


def _spec(kind, dtype):
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", dtype=dtype,
                                             device="cpu"))
    lim = dict(q0=Q0, q_max=Q0 + LIM, q_min=Q0 - LIM, dtype=dtype, device="cpu")
    kps = [PosOrnKeypoint(*T1, PREC, H // 2), PosOrnKeypoint(*T2, PREC, H - 1)]
    if kind == "posorn":
        return make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=0.1,
                         **lim)
    if kind == "posorn2":
        qd, z3, z4 = np.diag([1, 1, 1, .1, .1, .1] * 2), [0] * 3, [0] * 4
        kps = [PosOrnKeypoint(*T1, qd, H // 2, dposition=z3, dorientation=z4),
               PosOrnKeypoint(*T2, qd, H - 1, dposition=z3, dorientation=z4)]
        return make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 2, dt=0.1,
                         dq_max=np.ones(7) * 0.2, dq_min=-np.ones(7) * 0.2, **lim)
    if kind == "posorn_time":
        tk = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), H // 2, 2.0),
              SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]), H - 1, 5.0)]
        return make_spec("posorn_time", robot, tk, np.ones(8) * 1e-5, H, 1, **lim)
    assert kind == "sequential"
    joint = make_spec("joint", robot, [AngularKeypoint(Q0 + 0.3, np.eye(7), H - 1)],
                      np.ones(7) * 1e-5, H, 1, dt=0.1,
                      **dict(lim, q_max=Q0 + 2 * LIM, q_min=Q0 - LIM / 2))
    pose = make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    return sequential_spec((pose, joint), np.ones(7) * 1e-5, dtype=dtype)


def _batch(spec, seed=0):
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    x0s = np.concatenate([q0s, np.zeros((B, spec.nx - 7))], axis=-1)
    U0s = np.zeros((B, H - 1, spec.nu))
    if spec.time_optimal:
        U0s[..., -1] = 0.1
    dt = spec.dtype
    return torch.as_tensor(x0s, dtype=dt), torch.as_tensor(U0s, dtype=dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_affine_trial_without_xa_equals_the_old_trial(dtype, monkeypatch):
    """The flagship's line search (the walk on the affine family), limits
    binding: cost, alpha, Xn, Un, sum ||du|| and the trial count of the
    trial that reads Xb and Xd are the bits of the same walk with the old
    Xa trial's terms."""
    spec = _spec("posorn", DTYPES[dtype])
    cc = fleet._Consts(spec)
    x0s, U0s = _batch(spec)
    x0 = x0s.T.contiguous()
    U0 = U0s.permute(1, 2, 0).contiguous()
    zK = x0.new_zeros((H - 1, cc.m, cc.n, B))
    X, U, cost0, _ = fleet._rollout(cc, 0.0, zK, x0.new_zeros((H - 1, cc.m, B)),
                                    x0.new_zeros((H, cc.n, B)), U0, x0)
    for _ in range(3):      # walk a few iterations so the limits bind
        Ks, ds = fleet._backward(cc, X, U)
        inactive = torch.zeros(B, dtype=torch.bool)
        args = (cc, fleet._alpha_schedule(True), X, U, cost0, Ks, ds, x0, inactive)
        new = fleet._run_trials_affine(*args)
        with monkeypatch.context() as m:
            _patch_old_stage_terms(m)
            old = fleet._run_trials_affine(*args)
        assert new[-1] == old[-1]
        for a, b in zip(new[:-1], old[:-1]):
            assert _same_bits(a, b)
        X, U, cost0 = new[0], new[1], new[2]
    assert bool((_old_cost_full(cc, X) > 0).any())


@pytest.mark.parametrize("kind", ["posorn", "posorn2", "posorn_time",
                                  "sequential"])
def test_fleet_solve_equals_the_old_penalty_path(kind, monkeypatch):
    """A whole fleet solve (float64, limits binding) with the kernel's twins
    gives the bits of the same solve with the old penalty functions and the
    old Xa trial's terms patched in (first and second order, the time kind's
    re-rollouts, a sequential spec with two limited subsystems); no kernel
    launch is counted on the CPU."""
    spec = _spec(kind, torch.float64)
    x0s, U0s = _batch(spec, seed=3)
    with monkeypatch.context() as m:
        _patch_old_stage_terms(m)
        old = fleet.make_fleet_solver(spec, NB_ITER)(x0s, U0s)
    before = dict(lp.LAUNCHES)
    new = fleet.make_fleet_solver(spec, NB_ITER)(x0s, U0s)
    assert lp.LAUNCHES == before
    for name in ("X", "U", "Ks", "ds", "cost", "iterations", "alpha"):
        assert _same_bits(getattr(new, name), getattr(old, name)), name
    assert bool((new.iterations > 1).any())


# ---------------------------------------------------------------------------
# the kernel against its twins, on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _check_on_card(Xb, Xd, table, alpha):
    """Kernel (through the wrapper) against the twins on the same CUDA
    tensors: arrays bit for bit, cost within the sum-order bound."""
    H, n, _ = Xb.shape
    before = dict(lp.LAUNCHES)
    lx, L2 = lp.limit_arrays(Xb, table=table)
    costs = [lp.limit_cost(Xb, table=table), lp.limit_cost(Xb, Xd, alpha, table=table)]
    torch.cuda.synchronize()
    assert lp.LAUNCHES == {"cost": before["cost"] + 2,
                           "arrays": before["arrays"] + 1}
    rlx, rL2 = lp.limit_arrays_reference(Xb, table=table)
    assert _same_bits(lx, rlx) and _same_bits(L2, rL2)
    refs = [lp.limit_cost_reference(Xb, table=table),
            lp.limit_cost_reference(Xb, Xd, alpha, table=table)]
    tol = H * n * table.shape[0] * torch.finfo(Xb.dtype).eps
    for got, want in zip(costs, refs):
        exact = ~torch.isfinite(want) | (want == 0)
        assert _same_bits(got[exact], want[exact])
        rel = ((got - want).abs() / want.abs())[~exact]
        assert rel.numel() == 0 or float(rel.max()) <= tol, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twins_on_card(case, dtype):
    """Every limit table, with NaN and inf entries, at batches that take
    each vector width and warp split (1, 3, 45, 256, 4133, 36864), on the
    affine family's strided views and on contiguous copies."""
    _need_card()
    dt = DTYPES[dtype]
    cc, n = _consts(case, dt, "cuda")
    for Bc in (1, 3, 45, 256, 4133, 36864):
        Xb, Xd = _trajectory(12, n, Bc, dt, seed=Bc, device="cuda")
        _check_on_card(Xb, Xd, cc.limit_table, 0.25)
        _check_on_card(Xb.contiguous(), Xd.contiguous(), cc.limit_table, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell", ["posorn", "timeopt"])
def test_kernel_matches_twins_at_the_bulk_shapes(cell, dtype):
    """The bulk cells' shapes (posorn: the affine family [100, 2, 7,
    294912]; timeopt: a rollout's contiguous [100, 8, 131072]), limits
    at +-1 on unit-normal states so about a third of the entries bind."""
    _need_card()
    dt = DTYPES[dtype]
    n, Bc = (7, 294912) if cell == "posorn" else (8, 131072)
    ones = torch.ones(n, dtype=dt, device="cuda")
    weight = ones.clone()
    if cell == "timeopt":
        weight[-1] = 0.0
    table = torch.stack([ones, -ones, weight, ones])[None].contiguous()
    Xb, Xd = _trajectory(100, n, Bc, dt, seed=7, device="cuda", scale=1.0)
    if cell == "timeopt":
        Xb, Xd = Xb.contiguous(), Xd.contiguous()
    _check_on_card(Xb, Xd, table, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["posorn", "posorn_time"])
def test_every_limit_evaluation_of_a_solve_is_one_launch(kind):
    """A float32 fleet solve on the card (the bulk cells' kinds, H = 100,
    B = 2048): the kernel launches 1 + trials + sweeps times (the initial
    rollout's cost, one cost a trial, one arrays form a sweep)."""
    _need_card()
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", dtype=torch.float32,
                                             device="cuda"))
    Hc, Bc = 100, 2048
    lim = dict(q0=Q0, q_max=np.full(7, 10 * np.pi), q_min=np.full(7, -10 * np.pi),
               dtype=torch.float32, device="cuda")
    if kind == "posorn":
        kps = [PosOrnKeypoint(*T1, PREC, 49), PosOrnKeypoint(*T2, PREC, 99)]
        spec = make_spec("posorn", robot, kps, np.ones(7) * 1e-5, Hc, 1, dt=0.1,
                         **lim)
    else:
        kps = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), 49, 2.0),
               SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]), 99, 5.0)]
        spec = make_spec("posorn_time", robot, kps, np.ones(8) * 1e-5, Hc, 1,
                         **dict(lim, q0=np.zeros(7)))
    rng = np.random.default_rng(5)
    q0 = Q0 if kind == "posorn" else np.zeros(7)
    x0s = np.concatenate([q0[None] + 0.05 * rng.normal(size=(Bc, 7)),
                          np.zeros((Bc, spec.nx - 7))], axis=-1)
    U0s = np.zeros((Bc, Hc - 1, spec.nu))
    if kind == "posorn_time":
        U0s[..., -1] = 0.01
    solve = fleet.make_fleet_solver(spec, 10)
    before = (dict(lp.LAUNCHES), fleet.TRIALS, sb.LAUNCHES, sb2.LAUNCHES["time1"])
    res = solve(torch.as_tensor(x0s, dtype=torch.float32, device="cuda"),
                torch.as_tensor(U0s, dtype=torch.float32, device="cuda"))
    torch.cuda.synchronize()
    trials = fleet.TRIALS - before[1]
    sweeps = sb.LAUNCHES - before[2] + sb2.LAUNCHES["time1"] - before[3]
    assert trials > 0 and sweeps > 0
    assert lp.LAUNCHES["cost"] - before[0]["cost"] == 1 + trials
    assert lp.LAUNCHES["arrays"] - before[0]["arrays"] == sweeps
    assert bool(torch.isfinite(res.cost).all())
