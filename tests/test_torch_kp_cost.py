"""The keypoint-cost kernel's coverage, table and call sites in the fleet
solver, on the CPU; the kernel against its twin on the card (marked
`cuda`).

On the CPU the fleet runs the twin (`fleet._kp_cost_ops`), which is the
keypoint-cost sequence the fleet ran before the kernel (kept below as
`_old_*`: the rollout's `_static_step_costs` and the affine line search's
trial): every check here is bit for bit, whole solves included. On the card
the kernel differs from the twin where the math library's sin, cos and
acos do, and acos is steep at a reached target (one ulp of the dot product
moves the distance by ~1e-4 in float32), so a lane is held against a
float64 evaluation of the same lanes: its error is at most twice the
float32 twin's own, plus 1e-6 max(1, cost). No JAX here: the card tests
run on a machine without it.
"""

import re

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.models.planar import PlanarRobot
from ilqr_planner_torch.ops import so3
from ilqr_planner_torch.ops.cuda_kernels import kp_cost as kpc
from ilqr_planner_torch.ops.cuda_kernels import rollout_time1
from ilqr_planner_torch.solvers import fleet
from ilqr_planner_torch.systems.keypoints import (AngularKeypoint,
                                                  PointKeypoint,
                                                  PosOrnKeypoint,
                                                  PosOrnKeypointDistFunct,
                                                  SpacetimeKeypoint)
from ilqr_planner_torch.systems.spec import make_spec, sequential_spec
from ilqr_planner_torch.utils.compilemeter import host_read

Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
PREC = np.diag([1, 1, 1, .1, .1, .1])
QMAX = np.full(7, 10 * np.pi)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# the two object frames of the reference's multi-frame tutorial
OBJ = (([0.63758403393523, 0.2994657314658187, 0.6042309402208079,
         -0.37244039285286973], [0.62, 0.05, 0.34]),
       ([-0.03647984, 0.94060485, 0.33742794, 0.00860923], [0.32, 0.05, 0.54]))


# ---------------------------------------------------------------------------
# the fleet's keypoint-cost path before the kernel
# ---------------------------------------------------------------------------

def _old_static_step_costs(cc, X, U, cost, kpa=None):
    for k in cc.kp_steps:
        if k < cc.H - 1:
            for i_sub, _ in cc.kp_at[k]:
                Rt = cc.subs[i_sub].Rt[:, None]
                cost = cost + (Rt * U[k] * U[k]).sum(0)
        kc, _, _ = fleet._kp_terms_at(cc, k, X[k], False, kpa)
        cost = cost + kc
    return cost


def _old_trial_cost(cc, Xb, Xd, Ub, Ud, a, kpa=None):
    cost = fleet._limit_cost_full(cc, Xb, Xd, a)
    for k in cc.kp_steps:
        if k < cc.H - 1:
            uk = Ub[k] + a * Ud[k]
            for i_sub, _ in cc.kp_at[k]:
                cost = cost + (cc.subs[i_sub].Rt[:, None] * uk * uk).sum(0)
        kc, _, _ = fleet._kp_terms_at(cc, k, Xb[k] + a * Xd[k], False, kpa)
        cost = cost + kc
    return cost


def _old_run_trials_affine(cc, a_sched, X, U, cost0, Ks, ds, x0, inactive,
                           kpa=None):
    Xb, Xd, Ub, Ud, qa, qb, qc = fleet._affine_family(cc, Ks, ds, X, U, x0)

    def trial(a):
        cost = _old_trial_cost(cc, Xb, Xd, Ub, Ud, a, kpa)
        du = torch.sqrt(torch.clamp(qa + (2.0 * a) * qb + (a * a) * qc,
                                    min=0.0)).sum(0)
        return cost, du

    accepted = inactive.clone()
    cost = cost0
    du_acc = torch.zeros_like(cost0)
    alpha = torch.ones_like(cost0)
    n_trials = 0
    for a in a_sched:
        if host_read(accepted.all()):
            break
        ct, dut = trial(a)
        n_trials += 1
        ok = (ct < cost0) & ~torch.isnan(ct)
        take = ~accepted
        cost = torch.where(take, ct, cost)
        du_acc = torch.where(take, dut, du_acc)
        alpha = torch.where(take, torch.full_like(alpha, a), alpha)
        accepted = accepted | ok
    return Xb + alpha * Xd, Ub + alpha * Ud, cost, du_acc, alpha, n_trials


def _old_rollout(cc, alpha, Ks, ds, Xref, Uref, x0, kpa=None):
    if cc.time and cc.nb_deriv == 1:
        X, U, du2 = rollout_time1.rollout_time1(alpha, Ks, ds, Xref, Uref, x0)
    else:
        dt, dof = cc.dt, cc.dof
        X = x0.new_empty((cc.H,) + tuple(x0.shape))
        U = x0.new_empty(tuple(Uref.shape))
        du2 = x0.new_empty((cc.H - 1, x0.shape[-1]))
        X[0] = x = x0
        for k in range(cc.H - 1):
            du = (Ks[k] * (x - Xref[k])[None]).sum(1) + alpha * ds[k]
            u = Uref[k] + du
            if cc.time:
                s = u[cc.m - 1]
                dtk = s * s
                q, dq, ddq = x[:dof], x[dof:2 * dof], u[:dof]
                x = torch.cat([q + dtk * dq + (0.5 * dtk * dtk) * ddq,
                               dq + dtk * ddq, x[2 * dof:] + dtk])
            elif cc.nb_deriv == 2:
                x = torch.cat([x[:dof] + dt * x[dof:] + (0.5 * dt * dt) * u,
                               x[dof:] + dt * u])
            else:
                x = x + dt * u
            X[k + 1], U[k], du2[k] = x, u, (du * du).sum(0)
    cost = _old_static_step_costs(cc, X, U, fleet._limit_cost_full(cc, X), kpa)
    return X, U, cost, torch.sqrt(du2).sum(0)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _robot(dtype, device):
    return Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                            "panda_tip", dtype=dtype,
                                            device=device))


def _frames():
    out = []
    for quat, pos in OBJ:
        T = np.eye(4)
        T[:3, :3] = so3.quat_to_mat(torch.tensor(quat, dtype=torch.float64)).numpy()
        T[:3, 3] = pos
        out.append(torch.as_tensor(T))
    return out


# kind -> (covered by the kernel, horizon)
SPECS = {"posorn": (True, 100), "timeopt": (True, 100),
         "two_frames": (True, 30), "dead_zones": (True, 30),
         "point": (True, 30), "overrides": (False, 30),
         "posorn2nd": (False, 30), "hybrid": (False, 30),
         "planar": (False, 30)}
COVERED = [k for k, (c, _) in SPECS.items() if c]


def _spec(kind, dtype, device="cpu"):
    """The bulk cells' specs (posorn, timeopt: H=100, keypoints at 49 and
    99), a sequential spec over two object frames (three keypoints, two at
    the last step), constant dead zones, a point target, and specs the
    kernel does not cover: per-lane keypoint overrides, the double
    integrator, a joint + pose sequential spec, a planar robot."""
    H = SPECS[kind][1]
    lim = dict(q0=Q0, q_max=QMAX, q_min=-QMAX, dtype=dtype, device=device)
    if kind == "planar":
        robot = Robot.from_planar(PlanarRobot(torch.ones(3, dtype=dtype,
                                                         device=device)))
        return make_spec("point", robot, [PointKeypoint([1.5, 1.0], np.eye(2), H - 1)],
                         np.ones(3) * 1e-5, H, 1, dt=0.1,
                         **dict(lim, q0=[0.3, 0.2, 0.1], q_max=np.full(3, 10.0),
                                q_min=np.full(3, -10.0)))
    robot = _robot(dtype, device)
    kps = [PosOrnKeypoint(*T1, PREC, 49 if H == 100 else H // 2),
           PosOrnKeypoint(*T2, PREC, H - 1)]
    if kind in ("posorn", "overrides"):
        return make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    if kind == "timeopt":
        tk = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), 49, 2.0),
              SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]), 99, 5.0)]
        return make_spec("posorn_time", robot, tk, np.ones(8) * 1e-5, H, 1,
                         **dict(lim, q0=np.zeros(7)))
    if kind == "two_frames":
        f1, f2 = _frames()
        qd = np.diag([1, 1, 1, .5, .5, .5])
        s1 = make_spec("posorn", robot.with_frame(f1),
                       [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], qd, H // 2),
                        PosOrnKeypoint([0, 0, -0.1], [1, 0, 0, 0], qd, H - 1)],
                       np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
        s2 = make_spec("posorn", robot.with_frame(f2),
                       [PosOrnKeypoint([0.1, 0.1, -0.1], [1, 0, 0, 0], qd, H - 1)],
                       np.ones(7) * 2e-5, H, 1, dt=0.1, **lim)
        return sequential_spec((s1, s2), np.ones(7) * 1e-5, dtype=dtype)
    if kind == "dead_zones":
        dz = [PosOrnKeypointDistFunct(*T1, PREC, H // 2, pos_radius=0.05,
                                      orn_thresh=(0.05, 0.0, 0.3)),
              PosOrnKeypointDistFunct(*T2, PREC, H - 1, pos_radius=0.02)]
        return make_spec("posorn", robot, dz, np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    if kind == "point":
        pk = [PointKeypoint(T1[0], np.eye(3), H // 2),
              PointKeypoint(T2[0], np.eye(3) * 2, H - 1)]
        return make_spec("point", robot, pk, np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    if kind == "posorn2nd":
        qd, z3, z4 = np.diag([1, 1, 1, .1, .1, .1] * 2), [0] * 3, [0] * 4
        k2 = [PosOrnKeypoint(*T1, qd, H // 2, dposition=z3, dorientation=z4),
              PosOrnKeypoint(*T2, qd, H - 1, dposition=z3, dorientation=z4)]
        return make_spec("posorn", robot, k2, np.ones(7) * 1e-5, H, 2, dt=0.1, **lim)
    assert kind == "hybrid"
    sj = make_spec("joint", robot, [AngularKeypoint(Q0 + 0.2, np.eye(7) * 0.1, H // 2)],
                   np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    st = make_spec("posorn", robot, [PosOrnKeypoint(*T2, PREC, H - 1)],
                   np.ones(7) * 1e-5, H, 1, dt=0.1, **lim)
    return sequential_spec((sj, st), np.ones(7) * 1e-5, dtype=dtype)


def _overrides(spec, B, seed=4):
    """Per-lane targets (moved by N(0, 0.02)) and dead-zone radii."""
    rng = np.random.default_rng(seed)
    mu = spec.mu.cpu().numpy()[None].repeat(B, 0)
    mu[..., :3] += 0.02 * rng.normal(size=mu[..., :3].shape)
    radius = rng.uniform(0, 0.01, size=(B, spec.horizon))
    dt = spec.dtype
    return {"mu": torch.as_tensor(mu, dtype=dt, device=spec.device),
            "pos_radius": torch.as_tensor(radius, dtype=dt, device=spec.device)}


def _consts(kind, dtype, device="cpu"):
    spec = _spec(kind, dtype, device)
    ov = ("mu", "pos_radius") if kind == "overrides" else ()
    return spec, fleet._Consts(spec, ov)


def _batch(spec, B, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    q0 = np.zeros(spec.dof) if spec.time_optimal else np.asarray(spec.q0.cpu())
    q0s = q0[None] + scale * rng.normal(size=(B, spec.dof))
    x0s = np.concatenate([q0s, np.zeros((B, spec.nx - spec.dof))], axis=-1)
    U0s = np.zeros((B, spec.horizon - 1, spec.nu))
    if spec.time_optimal:
        U0s[..., -1] = 0.1
    dt = spec.dtype
    return (torch.as_tensor(x0s, dtype=dt, device=spec.device),
            torch.as_tensor(U0s, dtype=dt, device=spec.device))


def _family(spec, cc, B, seed, kpa=None):
    """An affine family [H, 2, n, B] (Xb, Xd views), Ub, Ud (a view of
    [H-1, 2, m, B]) and a rollout's X, U from a few iterations of a solve,
    lanes moved by up to 0.3 rad so that some lie far from the targets."""
    x0s, U0s = _batch(spec, B, seed, scale=0.3)
    ov = _overrides(spec, B) if cc.ov_names else None
    res = fleet.make_fleet_solver(spec, 2, overrides=cc.ov_names)(x0s, U0s, ov)
    X = res.X.permute(1, 2, 0).contiguous()
    U = res.U.permute(1, 2, 0).contiguous()
    g = torch.Generator(device="cpu").manual_seed(seed)
    Xbd = torch.stack([X, 0.1 * torch.randn(X.shape, generator=g, dtype=X.dtype)
                       .to(X.device)], 1)
    Ubd = torch.stack([U, 0.1 * torch.randn(U.shape, generator=g, dtype=U.dtype)
                       .to(U.device)], 1)
    kpa = fleet._bind_ov(cc, ov)
    return X, U, Xbd[:, 0], Xbd[:, 1], Ubd[:, 0].contiguous(), Ubd[:, 1], kpa


def _bits(t):
    t = t.contiguous()
    if t.is_floating_point():
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
    return t


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a).cpu(), _bits(b).cpu()))


# ---------------------------------------------------------------------------
# coverage and the table (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(SPECS))
def test_coverage_picks_the_kernel_for_the_listed_kinds(kind):
    """The kernel path is chosen once per `_Consts`, from the spec: the
    first-order posorn, posorn_time and point systems on one serial chain,
    with or without object frames, constant keypoints; not per-lane
    overrides, the double integrator, a joint subsystem or a planar
    robot."""
    spec, cc = _consts(kind, torch.float64)
    assert kpc.covers(cc) == SPECS[kind][0]
    assert (cc.kp_table is not None) == SPECS[kind][0]
    if not SPECS[kind][0]:
        with pytest.raises(ValueError, match="coverage"):
            kpc.kp_table(cc, None)


@pytest.mark.parametrize("kind", COVERED)
def test_table_holds_the_tensor_paths_constants(kind):
    """The table's header counts the joints, systems, keypoint steps and
    keypoints; the values at each joint's, system's and keypoint's offsets
    are the constants the tensor path reads, bit for bit; the table fits a
    block's shared memory."""
    _, cc = _consts(kind, torch.float32)
    t = cc.kp_table
    meta = t.meta.tolist()
    rep = cc.chain_of[0]
    nj, nsys, nsteps, nkp = meta[:4]
    assert (nj, nsys, nsteps) == (len(rep.prismatic), len(cc.subs), len(cc.kp_steps))
    assert nkp == sum(len(cc.kp_at[k]) for k in cc.kp_steps)
    assert meta[kpc.HEADER:kpc.HEADER + nj] == [int(p) for p in rep.prismatic]
    v = t.vals
    for i in range(nj):
        o = kpc.JOINT * i
        want = torch.cat([rep.origin_pos[i].reshape(-1),
                          rep.origin_rot[i].reshape(-1), rep.axis[i].reshape(-1),
                          rep.skew[i].reshape(-1), rep.skew2[i].reshape(-1)])
        assert _same_bits(v[o:o + kpc.JOINT], want)
    sys0 = kpc.HEADER + nj
    steps0 = sys0 + kpc.SYS * nsys
    kps0 = steps0 + kpc.STEP * nsteps
    for s, sc in enumerate(cc.subs):
        kind_code, time, frame, rt = meta[sys0 + kpc.SYS * s:sys0 + kpc.SYS * (s + 1)]
        assert kind_code == kpc.KINDS[sc.kind] and time == int(sc.time)
        assert _same_bits(v[rt:rt + cc.m], sc.Rt)
        assert (frame >= 0) == (sc.frame is not None)
        if frame >= 0:
            assert _same_bits(v[frame:frame + 9], sc.frame[0].reshape(-1))
    e = 0
    for j, k in enumerate(cc.kp_steps):
        assert meta[steps0 + kpc.STEP * j:steps0 + kpc.STEP * (j + 1)] == [
            k, e, len(cc.kp_at[k])]
        for i, kp in cc.kp_at[k]:
            row = meta[kps0 + kpc.KP * e:kps0 + kpc.KP * (e + 1)]
            sys_i, nq, mu, nt, prec, quat, zone, flags = row
            assert (sys_i, nq, nt) == (i, cc.subs[i].nq, cc.subs[i].nt)
            assert _same_bits(v[mu:mu + nt], kp["mu"].reshape(-1))
            assert _same_bits(v[prec:prec + nq * nq], kp["prec"].reshape(-1))
            if quat >= 0:
                assert _same_bits(v[quat:quat + 12], kp["E"].reshape(-1))
                assert _same_bits(v[quat + 12:quat + 16], kp["q"][1].reshape(-1))
            assert float(v[zone]) == kp["radius"]
            assert bool(flags & kpc.RADIUS) == (kp["radius"] != 0.0)
            assert bool(flags & kpc.THRESH) == any(x != 0.0 for x in kp["thresh"])
            e += 1
    assert kpc.smem_bytes(t) <= kpc.SMEM_MAX


@pytest.mark.parametrize("kind", COVERED)
def test_wrapper_runs_the_twin_on_the_cpu(kind):
    """For CPU tensors the wrapper runs the table's twin, the fleet's tensor
    path `_kp_cost_ops`, in both forms (bit for bit), and counts no
    launch."""
    spec, cc = _consts(kind, torch.float64)
    X, U, Xb, Xd, Ub, Ud, _ = _family(spec, cc, 5, seed=1)
    cost = torch.rand(5, dtype=torch.float64)
    before = kpc.LAUNCHES
    for args in ((X, U, cost), (Xb, Ub, cost, Xd, Ud, 0.5)):
        assert _same_bits(kpc.kp_cost(*args, table=cc.kp_table),
                          fleet._kp_cost_ops(cc, *args))
    assert kpc.LAUNCHES == before


def test_wrapper_constants_are_the_sources():
    """The wrapper's block size, row limit, table layout and flags are the
    ones `csrc/kp_cost.cu` defines."""
    src = kpc.SOURCE.read_text()

    def const(name):
        m = re.search(rf"\b{name}\s*=\s*(\d+)", src)
        return int(m.group(1))

    assert int(re.search(r"#define KP_THREADS (\d+)", src).group(1)) == kpc.THREADS
    assert const("kMaxRows") == kpc.MAX_ROWS
    assert [const(n) for n in ("kHeader", "kJoint", "kSys", "kStep", "kKp")] == [
        kpc.HEADER, kpc.JOINT, kpc.SYS, kpc.STEP, kpc.KP]
    assert [const(n) for n in ("kTargetZero", "kRadius", "kThresh")] == [
        kpc.TARGET_ZERO, kpc.RADIUS, kpc.THRESH]
    assert f"smem > {kpc.SMEM_MAX // 1024} * 1024" in src
    assert max(sc.nq for kind in COVERED
               for sc in _consts(kind, torch.float64)[1].subs) <= kpc.MAX_ROWS


# ---------------------------------------------------------------------------
# the fleet's costs and whole solves against the old path (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["posorn", "timeopt", "two_frames",
                                  "dead_zones", "point", "overrides"])
def test_trial_and_rollout_cost_equal_the_old_path(kind, dtype):
    """`_kp_cost` on CPU tensors gives the old sequence's bits: the plain
    form against `_static_step_costs` (each rollout), the affine form
    against the old trial (each line-search trial of the LTI kinds), at
    several alphas; an override-bound spec keeps the tensor path; no
    kernel launch is counted."""
    spec, cc = _consts(kind, DTYPES[dtype])
    X, U, Xb, Xd, Ub, Ud, kpa = _family(spec, cc, 6, seed=len(kind))
    before = kpc.LAUNCHES
    cost0 = fleet._limit_cost_full(cc, X)
    assert _same_bits(fleet._kp_cost(cc, X, U, cost0, kpa=kpa),
                      _old_static_step_costs(cc, X, U, cost0, kpa))
    for a in (1.0, 0.25, 2.0 ** -10):
        want = _old_trial_cost(cc, Xb, Xd, Ub, Ud, a, kpa)
        got = fleet._kp_cost(cc, Xb, Ub, fleet._limit_cost_full(cc, Xb, Xd, a),
                             Xd, Ud, a, kpa)
        assert _same_bits(got, want)
    assert kpc.LAUNCHES == before


@pytest.mark.parametrize("kind", ["posorn", "timeopt", "two_frames",
                                  "dead_zones", "overrides"])
def test_fleet_solve_equals_the_old_path(kind, monkeypatch):
    """A whole fleet solve (float64) gives the bits of the same solve with
    the old rollout cost and the old affine trial patched in: X, U, Ks, ds,
    cost, iterations and alpha."""
    spec = _spec(kind, torch.float64)
    B = 6
    x0s, U0s = _batch(spec, B, seed=3)
    names = ("mu", "pos_radius") if kind == "overrides" else ()
    ov = _overrides(spec, B) if names else None
    nb_iter = 4 if spec.horizon == 100 else 6
    with monkeypatch.context() as m:
        m.setattr(fleet, "_rollout", _old_rollout)
        m.setattr(fleet, "_run_trials_affine", _old_run_trials_affine)
        old = fleet.make_fleet_solver(spec, nb_iter, overrides=names)(x0s, U0s, ov)
    before = kpc.LAUNCHES
    new = fleet.make_fleet_solver(spec, nb_iter, overrides=names)(x0s, U0s, ov)
    assert kpc.LAUNCHES == before
    for name in ("X", "U", "Ks", "ds", "cost", "iterations", "alpha"):
        assert _same_bits(getattr(new, name), getattr(old, name)), name
    assert bool((new.iterations > 1).any())


# ---------------------------------------------------------------------------
# the kernel against its twin, on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", COVERED)
def test_kernel_matches_twin_on_card(kind, dtype):
    """Both forms at ragged batches (1, 45, 4133), with NaN lanes: every
    lane's error against a float64 evaluation of the same lanes is at most
    twice the twin's own plus 1e-6 max(1, cost) (in float64 the twin is the
    evaluation: 1e-9 max(1, cost)); a NaN lane of the twin is NaN; each call
    is one launch and leaves no CUDA error."""
    _need_card()
    dt = DTYPES[dtype]
    spec, cc = _consts(kind, dt, "cuda")
    _, cc64 = _consts(kind, torch.float64, "cuda")
    for Bc in (1, 45, 4133):
        X, U, Xb, Xd, Ub, Ud, _ = _family(spec, cc, Bc, seed=Bc)
        X[SPECS[kind][1] - 1, 0, 0] = float("nan")
        cost = torch.rand(Bc, dtype=dt, device="cuda")
        for args in ((X, U, cost), (Xb, Ub, cost, Xd, Ud, 0.5)):
            before = kpc.LAUNCHES
            got = kpc.kp_cost(*args, table=cc.kp_table)
            torch.cuda.synchronize()
            assert kpc.LAUNCHES == before + 1
            twin = fleet._kp_cost_ops(cc, *args)
            truth = fleet._kp_cost_ops(cc64, *(a.double() if torch.is_tensor(a)
                                               else a for a in args))
            nan = torch.isnan(twin)
            assert torch.equal(torch.isnan(got), nan)
            scale = torch.clamp(truth.abs(), min=1.0)[~nan]
            e_k = (got.double() - truth).abs()[~nan]
            e_t = (twin.double() - truth).abs()[~nan]
            if dt == torch.float64:
                assert bool((e_k <= 1e-9 * scale).all()), float((e_k / scale).max())
            else:
                assert bool((e_k <= 2 * e_t + 1e-6 * scale).all()), float(
                    ((e_k - 2 * e_t) / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["posorn", "timeopt", "two_frames",
                                  "overrides", "posorn2nd", "hybrid"])
def test_solve_launches_once_a_trial_or_never(kind):
    """A float32 fleet solve on the card: where the kernel covers the spec
    it launches once for the initial rollout and once a line-search trial;
    elsewhere never, the tensor path running instead; the costs are
    finite."""
    _need_card()
    spec = _spec(kind, torch.float32, "cuda")
    B = 256
    x0s, U0s = _batch(spec, B, seed=5)
    names = ("mu", "pos_radius") if kind == "overrides" else ()
    ov = _overrides(spec, B) if names else None
    solve = fleet.make_fleet_solver(spec, 5, overrides=names)
    before = (kpc.LAUNCHES, fleet.TRIALS)
    res = solve(x0s, U0s, ov)
    torch.cuda.synchronize()
    trials = fleet.TRIALS - before[1]
    assert trials > 0
    want = 1 + trials if SPECS[kind][0] else 0
    assert kpc.LAUNCHES - before[0] == want
    assert bool(torch.isfinite(res.cost).all())


@pytest.mark.cuda
def test_wrapper_raises_on_what_it_cannot_take():
    """A CUDA call the kernel cannot take raises before any launch: a
    float16 or mixed type, rows that are not contiguous, shapes other than
    the table's, Xd without Ud."""
    _need_card()
    spec, cc = _consts("posorn", torch.float32, "cuda")
    B = 8
    X = torch.zeros(cc.H, cc.n, B, device="cuda")
    U = torch.zeros(cc.H - 1, cc.m, B, device="cuda")
    cost = torch.zeros(B, device="cuda")
    bad = [((X.half(), U, cost), TypeError),
           ((X, U.double(), cost), TypeError),
           ((X.transpose(1, 2).contiguous().transpose(1, 2), U, cost), ValueError),
           ((X[:, :, :4], U, cost), ValueError),
           ((X[:-1], U, cost), ValueError),
           ((X, U, cost, X), ValueError)]
    before = kpc.LAUNCHES
    for args, err in bad:
        with pytest.raises(err):
            kpc.kp_cost(*args, table=cc.kp_table)
    assert kpc.LAUNCHES == before
