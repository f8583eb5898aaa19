"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Three paths, each through `ilqr_planner_torch.parallel.solve_batch` on a
7-DoF Panda, float32:
  flagship   position + quaternion via-points at steps 49 and 99, H=100,
             dt=0.1, 10 iterations, B=36864 (backward: segment_backward);
  posorn2nd  the double integrator, via-points with velocity targets at
             199 and 399, H=400, dt=0.01, 15 iterations, B=4096
             (backward: segment_backward_2nd);
  timeopt    the sqrt-dt time-optimal kind, spacetime via-points at 49
             (t=2) and 99 (t=5), H=100, 20 iterations, B=2048 (backward:
             segment_backward_time1; every line-search trial: rollout_time1).

Phases (each prints one JSON line; any failure exits non-zero):
  1. device and build: the card's name and power limit; the nvcc build of
     every kernel source, all started together, with each ptxas
     register/spill report;
  2. each kernel against its plain PyTorch twin at its path's shapes,
     float64 (the correctness gate, 1e-9 relative) and float32, with
     CUDA-event timings and the least time the card could take (bytes or
     operations bound);
  3. each path end to end: a first solve with every launch count set to 0
     just before it and read just after (each kernel of the path must have
     launched: once per backward sweep, and for the rollout once per
     line-search trial plus once for the solve's initial rollout), then the
     median of 5 timed repeats with the spread,
     solves/s, median cost and iterations;
  4. each path's first 64 lanes in float64, on the card and on the CPU
     (where the wrappers run the twins): same iterations and alpha per lane,
     cost within 1e-8 relative, or within 10 times the CPU's own spread
     under a 1e-15 relative change of x0 where the solve is that sensitive;
  5. a torch.profiler trace of one solve of each path: device busy time,
     its share of the unprofiled wall time, the top kernels (the full table
     goes to chiprun_out/profile_<path>.txt).
Then the kernel table and, last, {"ok": true, "device": {...}}.

It needs one card, and the repository it sits in; without either it fails
before printing any result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The flagship problem (the JAX package's bench.py workload).
Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777, 0.71771416])
T1 = ([0.554121212377707, -0.01575049935289518, 0.38295604872511507],
      [0.014042440828406944, 0.915047647731553, 0.4024820607528928,
       0.022333898196169735])
T2 = ([0.254121212377707, -0.07575049935289518, 0.13170744424127526],
      [0.029927010072216945, 0.9121514607332729, 0.4087591864532181,
       0.00011933313484481926])
H, N, B, NB_ITER, REPEATS = 100, 7, 36864, 10, 5
KP_INNER = (49,)          # the terminal keypoint (99) folds into P0
QD6 = [1, 1, 1, .1, .1, .1]

# The two configurations of the JAX package's bench_table.py rows
# posorn2nd_h400_ilqr15 and timeopt_h100_ilqr20, at their full batch, with
# the JAX package's own float32 median cost on its TPU (BENCH_TABLE.json):
# a quality target, never a speed.
PATHS = {
    "posorn2nd": dict(H=400, B=4096, nb_iter=15, n=14, m=7, kp_inner=(199,),
                      jax_median_cost=2.537e-3),
    "timeopt": dict(H=100, B=2048, nb_iter=20, n=8, m=8, kp_inner=(49,),
                    jax_median_cost=2.989e-5),
}
COST_RATIO_GATE = 2.0     # median cost within 2x of the JAX record

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

F64_REL_GATE = 1e-9       # kernel vs twin, float64 (only reduction order)
# Card vs CPU final cost, float64: within 1e-8 relative, or within 10 times
# the CPU run's own spread when its x0 moves by 1e-15 relative, whichever is
# larger. The time-optimal solve amplifies rounding: on the CPU alone that
# 1e-15 change moves its 20-iteration cost by up to 5.6e-8 (PERF.md, PR 2).
XCHECK_REL = 1e-8
XCHECK_SENS_FACTOR = 10.0
XCHECK_PERTURB = 1e-15
XCHECK_B = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# the three configurations
# ---------------------------------------------------------------------------

def _panda(dtype, device):
    from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                            "panda_tip", dtype=dtype,
                                            device=device))


def flagship_spec(torch, dtype, device):
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    prec = np.diag(QD6)
    kps = [PosOrnKeypoint(*T1, prec, 49), PosOrnKeypoint(*T2, prec, 99)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn", _panda(dtype, device), kps, np.ones(7) * 1e-5,
                     H, 1, dt=0.1, q0=Q0, q_max=qmax, q_min=-qmax, dtype=dtype,
                     device=device)


def flagship_batch(batch):
    rng = np.random.default_rng(0)
    q0s = Q0[None, :] + 0.05 * rng.normal(size=(batch, 7))
    return q0s, np.zeros((batch, H - 1, 7))


def posorn2nd_spec(torch, dtype, device):
    """bench_table.py posorn2nd_h400_ilqr15: the double integrator, H=400,
    dt=0.01, velocity limits +-10."""
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    Hp = PATHS["posorn2nd"]["H"]
    z3, z4 = [0, 0, 0], [0, 0, 0, 0]
    kps = [PosOrnKeypoint(*T1, np.diag(QD6 + [1, 1, 1, 0, 0, 0]), Hp // 2 - 1,
                          dposition=z3, dorientation=z4),
           PosOrnKeypoint(*T2, np.diag(QD6 + QD6), Hp - 1, dposition=z3,
                          dorientation=z4)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn", _panda(dtype, device), kps, np.ones(7) * 1e-5,
                     Hp, 2, dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax,
                     dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10,
                     dtype=dtype, device=device)


def posorn2nd_batch(batch):
    """x0 = [q0 + 0.05 N(0, 1) (seed 0), 0], U0 = 0."""
    rng = np.random.default_rng(0)
    q0s = Q0[None, :] + 0.05 * rng.normal(size=(batch, 7))
    x0s = np.concatenate([q0s, np.zeros_like(q0s)], axis=-1)
    return x0s, np.zeros((batch, PATHS["posorn2nd"]["H"] - 1, 7))


def timeopt_spec(torch, dtype, device):
    """bench_table.py timeopt_h100_ilqr20: the sqrt-dt time-optimal
    position + quaternion kind, q0 = 0, H=100."""
    from ilqr_planner_torch.systems.keypoints import SpacetimeKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    kps = [SpacetimeKeypoint(*T1, np.diag(QD6 + [0]), 49, 2.0),
           SpacetimeKeypoint(*T2, np.diag(QD6 + [0.1]), 99, 5.0)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn_time", _panda(dtype, device), kps,
                     np.ones(8) * 1e-5, PATHS["timeopt"]["H"], 1, dt=None,
                     q0=np.zeros(7), q_max=qmax, q_min=-qmax, dtype=dtype,
                     device=device)


def timeopt_batch(batch):
    """x0 = [0.05 N(0, 1) (seed 1), 0], U0 rows [0]*7 + [0.01]."""
    rng = np.random.default_rng(1)
    q0s = 0.05 * rng.normal(size=(batch, 7))
    x0s = np.concatenate([q0s, np.zeros((batch, 1))], axis=-1)
    U0 = np.tile(np.array([0.0] * 7 + [0.01]), (PATHS["timeopt"]["H"] - 1, 1))
    return x0s, np.tile(U0[None], (batch, 1, 1))


# ---------------------------------------------------------------------------
# kernel inputs, operation and byte counts
# ---------------------------------------------------------------------------

def sweep_inputs(n, m, hm1, n_kp, batch, seed=0):
    """Seeded sweep inputs scaled like a solve's: SPD terminal and keypoint
    Hessians, positive limit diagonal; for the time-optimal kind (n == m)
    step controls s in [0.05, 0.2), away from zero."""
    rng = np.random.default_rng(seed)

    def spd(*lead):
        A = rng.normal(size=lead + (n, n, batch)).astype(np.float32)
        return np.einsum("...ikb,...jkb->...ijb", A, A) / n

    L2 = rng.uniform(0.5, 1.5, size=(hm1, n, batch))
    U = 0.1 * rng.normal(size=(hm1, m, batch))
    if n == m:
        U[:, -1] = 0.05 + 0.05 * np.abs(U[:, -1])
    return (spd() + np.eye(n)[:, :, None], rng.normal(size=(n, batch)), L2,
            rng.normal(size=(hm1, n, batch)), U, spd(n_kp))


def sweep_flops(n, hm1, n_kp, batch):
    """Operations of one first-order sweep, counted from the kernel's loops
    (each add, multiply, divide or square root one)."""
    chol = sum(2 * j + 5 + (n - j - 1) * (2 * j + 3) for j in range(n))
    minv = sum(sum(2 * (i - c) + 2 for i in range(c + 1, n))
               + sum(2 * (n - 1 - i) + 2 for i in range(c, n))
               for c in range(n))
    d = 3 * n + n * 2 * n + n
    K = 3 * n * n
    P1 = n * (n + 1) // 2 * (2 * n + 6) + n
    p1 = n * (2 * n + 7)
    per_step = chol + minv + d + K + P1 + p1
    return batch * (hm1 * per_step + n_kp * n * (n + 1) // 2)


def sweep_bytes(n, hm1, n_kp, batch, itemsize, m=None):
    """Each input read once, each output written once; the kernels read only
    the upper triangles of P0 and of each keypoint Hessian gxx. m=None is
    the first-order sweep (m = n; parameters dt, reg, Rt), else the 2nd-order
    or time-optimal one (parameters dt, dt^2/2, reg, Rt)."""
    n_params = 2 + n if m is None else 3 + m
    m = n if m is None else m
    tri = n * (n + 1) // 2
    vals = (tri + n + hm1 * (2 * n + m) + n_kp * tri    # P0, p0, L2/lx/U, gxx
            + hm1 * m * n + hm1 * m)                    # Ks, ds
    return batch * vals * itemsize + hm1 * 4 + n_params * itemsize


def sweep2_flops(kind, n, m, hm1, n_kp, batch):
    """Operations of one 'second' or 'time1' sweep, counted from the loops of
    csrc/segment_backward_2nd.cu (each add, multiply or divide one; the
    sign flips of K and d counted too)."""
    second = kind == "second"
    dof = m if second else m - 1
    nx = n + 1

    def pa(c):        # P A ('second': dt * the q-column added)
        return 2 if second and c >= dof else 0

    def qux(r, c):    # one entry of B^T P A
        if second:
            return 3 + 2 * pa(c)
        return 1 if r < dof else 2 * dof + 2

    if second:        # Quu + reg I and Qu
        system = 9 * m * m + 2 * m + 5 * m
    else:             # s, 2s, g; P B's last column; Quu + reg I; Qu
        system = (2 + dof + n * (2 * dof + 2) + dof * (5 * dof + 5)
                  + 3 * dof + 4 + 5 * dof + 4)
    system += sum(qux(r, c) for r in range(m) for c in range(n))
    gauss = sum(1 + (m - 1 - k) + nx + (m - 1) * (2 * (m - 1 - k) + 2 * nx)
                for k in range(m))
    gains = m + m * n
    value = 0
    for i in range(n):
        qx = 3 if second and i >= dof else 1
        value += sum(qux(r, i) for r in range(m)) + 5 * m + qx + 3
        for j in range(i, n):
            if second:
                qxx = 1 + pa(j) if i < dof else 3 + 2 * pa(j)
            else:
                qxx = 1
            value += 5 * m + qxx + 3
    per_step = system + gauss + gains + value
    return batch * (hm1 * per_step + n_kp * n * (n + 1) // 2)


def rollout_flops(n, hm1, batch):
    """Operations of one time-optimal rollout, counted from the loops of
    csrc/rollout_time1.cu."""
    m, dof = n, n - 1
    per_step = n + m * (2 * n + 2 + 2 + 1) + 1 + 2 * dof + 1
    return batch * hm1 * per_step


def rollout_bytes(n, hm1, batch, itemsize):
    """Each input read once (gains, d, xo, uo per step and x0), each output
    written once (X with its row 0, U, ||du||^2)."""
    m = n
    vals = n + hm1 * (m * n + m + n + m) + (hm1 + 1) * n + hm1 * m + hm1
    return batch * vals * itemsize


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bytes_f32": nbytes, "flops": flops,
            "bound_ms_f32": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this recursion"}


def cuda_ms(torch, fn, reps=10, warm=2):
    """Median CUDA-event time of fn() in ms over `reps` timed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from ilqr_planner_torch.ops.cuda_kernels import (nvcc_build, rollout_time1,
                                                     segment_backward,
                                                     segment_backward_2nd)

    mods = (segment_backward, segment_backward_2nd, rollout_time1)
    t0 = time.time()
    with ThreadPoolExecutor(len(mods)) as ex:     # one nvcc per source
        built = list(ex.map(lambda mod: mod.build(), mods))
    build_s = time.time() - t0
    emit({"phase": "build", "nvidia_smi": smi, "build_s_all_parallel": build_s,
          "sources": {os.path.relpath(mod.SOURCE, REPO): {
              "library": os.path.relpath(lib, REPO),
              "ptxas": nvcc_build.ptxas_summary(report)}
              for mod, (lib, report) in zip(mods, built)}})


def _kernel_vs_twin(torch, name, shapes, args_np, call, twin, twin_reps):
    """Hold call(*args) against twin(*args) in float64 (gate) and float32;
    CUDA-event ms of each."""
    out = {"phase": "kernel_vs_twin", "name": name, "shapes": shapes}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        got = call(*args)
        torch.cuda.synchronize()
        ref = twin(*args)
        torch.cuda.synchronize()
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        out[f"max_abs_err_{tag}"] = abs_err
        out[f"max_rel_err_{tag}"] = abs_err / scale
        out[f"finite_{tag}"] = all(bool(torch.isfinite(g).all()) for g in got)
        del got, ref
        out[f"kernel_ms_{tag}"] = cuda_ms(torch, lambda: call(*args))
        out[f"twin_ms_{tag}"] = cuda_ms(torch, lambda: twin(*args),
                                        reps=twin_reps, warm=1)
        del args
        torch.cuda.empty_cache()
    return out


def _gate_kernel(out):
    emit(out)
    if not (out["finite_f64"] and out["finite_f32"]):
        fail(f"{out['name']}: kernel output not finite")
    if out["max_rel_err_f64"] > F64_REL_GATE:
        fail(f"{out['name']}: kernel vs twin float64 relative error "
             f"{out['max_rel_err_f64']} > {F64_REL_GATE}")
    return out


def phase_kernels_vs_twins(torch):
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2

    res = {}
    out = _kernel_vs_twin(
        torch, "segment_backward", {"n": N, "H": H, "B": B, "kp_inner": KP_INNER},
        sweep_inputs(N, N, H - 1, len(KP_INNER), B),
        lambda *a: sb.segment_backward(*a, KP_INNER, 0.1, [1e-5] * N),
        lambda *a: sb.segment_backward_reference(*a, KP_INNER, 0.1, [1e-5] * N),
        10)
    out.update(bound(sweep_bytes(N, H - 1, len(KP_INNER), B, 4),
                     sweep_flops(N, H - 1, len(KP_INNER), B)))
    res["segment_backward"] = _gate_kernel(out)

    for kind, path, dt, name in (
            ("second", "posorn2nd", 0.01, "segment_backward_2nd"),
            ("time1", "timeopt", None, "segment_backward_time1")):
        cfg = PATHS[path]
        n, m, hm1, kp = cfg["n"], cfg["m"], cfg["H"] - 1, cfg["kp_inner"]
        Rt = [1e-5] * m
        if kind == "second":
            def call(*a):
                return sb2.segment_backward_2nd(*a, kp, dt, Rt)
        else:
            def call(*a):
                return sb2.segment_backward_time1(*a, kp, Rt)
        out = _kernel_vs_twin(
            torch, name, {"kind": kind, "n": n, "m": m, "H": cfg["H"],
                          "B": cfg["B"], "kp_inner": kp},
            sweep_inputs(n, m, hm1, len(kp), cfg["B"], seed=1), call,
            lambda *a: sb2.segment_backward_2nd_reference(kind, *a, kp, dt, Rt),
            3)
        out.update(bound(sweep_bytes(n, hm1, len(kp), cfg["B"], 4, m),
                         sweep2_flops(kind, n, m, hm1, len(kp), cfg["B"])))
        res[kind] = _gate_kernel(out)

    cfg = PATHS["timeopt"]
    n, hm1, Bt = cfg["n"], cfg["H"] - 1, cfg["B"]
    rng = np.random.default_rng(2)
    Xref = np.cumsum(np.concatenate([0.05 * rng.normal(size=(1, n, Bt)),
                                     0.02 * rng.normal(size=(hm1, n, Bt))]), 0)
    Uref = 0.05 * rng.normal(size=(hm1, n, Bt))
    Uref[:, -1] = 0.05 + 0.05 * np.abs(Uref[:, -1])
    args = (0.1 * rng.normal(size=(hm1, n, n, Bt)),
            0.05 * rng.normal(size=(hm1, n, Bt)), Xref, Uref, Xref[0].copy())
    out = _kernel_vs_twin(
        torch, "rollout_time1", {"n": n, "H": cfg["H"], "B": Bt, "alpha": 0.5},
        args, lambda *a: rt1.rollout_time1(0.5, *a),
        lambda *a: rt1.rollout_time1_reference(0.5, *a), 5)
    out.update(bound(rollout_bytes(n, hm1, Bt, 4), rollout_flops(n, hm1, Bt)))
    res["rollout_time1"] = _gate_kernel(out)
    return res


def _reset_counts():
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
    from ilqr_planner_torch.solvers import fleet

    sb.LAUNCHES = 0
    rt1.LAUNCHES = 0
    for k in sb2.LAUNCHES:
        sb2.LAUNCHES[k] = 0
    fleet.TRIALS = 0


def _read_counts():
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
    from ilqr_planner_torch.solvers import fleet

    return {"segment_backward": sb.LAUNCHES,
            "segment_backward_2nd": sb2.LAUNCHES["second"],
            "segment_backward_time1": sb2.LAUNCHES["time1"],
            "rollout_time1": rt1.LAUNCHES, "trials": fleet.TRIALS}


def _drive(torch, spec, x0s, U0s, nb_iter):
    """One solve with every count at 0 just before it, then REPEATS timed
    ones -> (result, counts, first_s, repeat times, the solve as a
    callable)."""
    from ilqr_planner_torch.parallel import solve_batch

    x0s_t = torch.as_tensor(x0s, dtype=torch.float32, device="cuda")
    U0s_t = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    ov = {"q0": x0s_t[:, :7], "x0": x0s_t}

    def run():
        return solve_batch(spec, ov, U0s_t, nb_iter)

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    res = run()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    counts = _read_counts()
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        res = run()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return res, counts, first_s, times, run


def _result_summary(res, batch, first_s, times, counts, shapes):
    cost = res.cost.double().cpu().numpy()
    return {"batch": batch, "dtype": "float32", "first_call_s": first_s,
            "repeat_times_s": times,
            "solves_per_s_median": batch / statistics.median(times),
            "spread_max_over_min": max(times) / min(times),
            "median_cost": float(np.median(cost)),
            "finite_costs": bool(np.isfinite(cost).all()),
            "median_iterations": float(np.median(res.iterations.cpu().numpy())),
            "launches": counts,
            "shapes_ok": (tuple(res.X.shape), tuple(res.U.shape),
                          tuple(res.fX.shape)) == shapes,
            "finite": bool(res.X.isfinite().all() and res.U.isfinite().all())}


def phase_flagship(torch):
    from ilqr_planner_torch.parallel import mesh
    from ilqr_planner_torch.solvers.fleet import make_fleet_solver

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = flagship_batch(B)
    res, counts, first_s, times, run = _drive(torch, spec, q0s, U0s, NB_ITER)
    sweeps = int(res.iterations.max())
    # host cost of the solver memo: a hit fingerprints the spec, a miss
    # also builds the solver's constants
    fp_s, build_s = [], []
    for _ in range(REPEATS):
        t0 = time.time()
        mesh._spec_fingerprint(spec)
        fp_s.append(time.time() - t0)
        t0 = time.time()
        make_fleet_solver(spec, NB_ITER)
        build_s.append(time.time() - t0)
    out = {"phase": "end_to_end", "path": "flagship", "nb_iter": NB_ITER,
           **_result_summary(res, B, first_s, times, counts,
                             ((B, H, N), (B, H - 1, N), (B, H, 7))),
           "memo_hit_ms": 1e3 * statistics.median(fp_s),
           "memo_miss_extra_ms": 1e3 * statistics.median(build_s),
           "converged_frac": float(np.mean(res.cost.double().cpu().numpy() < 1e-4)),
           "backward_sweeps": sweeps}
    emit(out)
    if not out["shapes_ok"] or not out["finite"]:
        fail("flagship: result has the wrong shape or non-finite values")
    if not math.isfinite(out["median_cost"]):
        fail("flagship: median cost is not finite")
    if out["converged_frac"] < 0.95:
        fail(f"flagship: converged fraction {out['converged_frac']} < 0.95")
    if counts["segment_backward"] == 0 or counts["segment_backward"] != sweeps:
        fail(f"flagship: segment_backward launched {counts['segment_backward']} "
             f"times for {sweeps} sweeps")
    return out, run


def _config(path):
    """(spec builder, batch builder, batch size, iterations) of a path."""
    if path == "flagship":
        return flagship_spec, flagship_batch, B, NB_ITER
    fns = ((posorn2nd_spec, posorn2nd_batch) if path == "posorn2nd"
           else (timeopt_spec, timeopt_batch))
    return fns + (PATHS[path]["B"], PATHS[path]["nb_iter"])


def phase_new_path(torch, path):
    cfg = PATHS[path]
    spec_fn, batch_fn, _, _ = _config(path)
    spec = spec_fn(torch, torch.float32, "cuda")
    x0s, U0s = batch_fn(cfg["B"])
    res, counts, first_s, times, run = _drive(torch, spec, x0s, U0s,
                                              cfg["nb_iter"])
    Hp, Bp, n, m = cfg["H"], cfg["B"], cfg["n"], cfg["m"]
    out = {"phase": "end_to_end", "path": path, "nb_iter": cfg["nb_iter"],
           **_result_summary(res, Bp, first_s, times, counts,
                             ((Bp, Hp, n), (Bp, Hp - 1, m), (Bp, Hp, spec.nt))),
           "jax_tpu_median_cost": cfg["jax_median_cost"]}
    out["median_cost_over_jax"] = out["median_cost"] / cfg["jax_median_cost"]
    emit(out)
    if not out["shapes_ok"] or not out["finite"] or not out["finite_costs"]:
        fail(f"{path}: result has the wrong shape or non-finite values")
    ratio = out["median_cost_over_jax"]
    if not 1 / COST_RATIO_GATE <= ratio <= COST_RATIO_GATE:
        fail(f"{path}: median cost {out['median_cost']} not within "
             f"{COST_RATIO_GATE}x of the JAX record {cfg['jax_median_cost']}")
    sweeps = int(res.iterations.max())      # one backward sweep an iteration
    kern = "segment_backward_2nd" if path == "posorn2nd" else "segment_backward_time1"
    if sweeps == 0 or counts[kern] != sweeps:
        fail(f"{path}: {kern} launched {counts[kern]} times for {sweeps} sweeps")
    # the time-optimal rollout: once per line-search trial, and once for the
    # solve's initial rollout
    if path == "timeopt" and (counts["trials"] == 0 or
                              counts["rollout_time1"] != counts["trials"] + 1):
        fail(f"timeopt: rollout_time1 launched {counts['rollout_time1']} times "
             f"for {counts['trials']} trials and 1 initial rollout")
    others = [k for k in ("segment_backward", "segment_backward_2nd",
                          "segment_backward_time1", "rollout_time1")
              if counts[k] and k != kern and not (path == "timeopt"
                                                  and k == "rollout_time1")]
    if others:
        fail(f"{path}: kernels of other paths launched: {others}")
    return out, run


def phase_cross_check(torch, path):
    """The path's first 64 lanes in float64 on the card and on the CPU."""
    from ilqr_planner_torch.solvers.fleet import make_fleet_solver

    spec_fn, batch_fn, batch, nb_iter = _config(path)
    x0s, U0s = batch_fn(batch)
    x0s, U0s = x0s[:XCHECK_B], U0s[:XCHECK_B]
    _reset_counts()
    gpu = make_fleet_solver(spec_fn(torch, torch.float64, "cuda"),
                            nb_iter)(x0s, U0s)
    torch.cuda.synchronize()
    gpu_counts = _read_counts()
    _reset_counts()
    cpu_solve = make_fleet_solver(spec_fn(torch, torch.float64, "cpu"), nb_iter)
    cpu = cpu_solve(x0s, U0s)
    cpu_counts = _read_counts()
    # the CPU's own spread: the same solve from x0 moved by 1e-15 relative
    x0p = x0s.copy()
    x0p[:, :7] *= 1.0 + XCHECK_PERTURB
    c_cpu = cpu.cost.numpy()
    spread = float(np.max(np.abs(cpu_solve(x0p, U0s).cost.numpy() - c_cpu)
                          / np.abs(c_cpu)))
    gate = max(XCHECK_REL, XCHECK_SENS_FACTOR * spread)
    kernels = ("segment_backward", "segment_backward_2nd",
               "segment_backward_time1", "rollout_time1")
    c_gpu = gpu.cost.cpu().numpy()
    rel = float(np.max(np.abs(c_gpu - c_cpu) / np.abs(c_cpu)))
    out = {"phase": "card_vs_cpu", "path": path, "batch": XCHECK_B,
           "dtype": "float64",
           "same_iterations": bool(np.array_equal(gpu.iterations.cpu().numpy(),
                                                  cpu.iterations.numpy())),
           "same_alpha": bool(np.array_equal(gpu.alpha.cpu().numpy(),
                                             cpu.alpha.numpy())),
           "cost_max_rel_diff": rel,
           "cost_median_rel_diff": float(np.median(np.abs(c_gpu - c_cpu)
                                                   / np.abs(c_cpu))),
           "cpu_self_spread_x0_1e-15": spread, "tolerance": gate,
           "card_kernel_launches": {k: gpu_counts[k] for k in kernels},
           "cpu_kernel_launches": {k: cpu_counts[k] for k in kernels},
           "U_max_abs_diff": float((gpu.U.cpu() - cpu.U).abs().max())}
    emit(out)
    if not (out["same_iterations"] and out["same_alpha"] and rel <= gate):
        fail(f"{path}: card and CPU disagree")
    if sum(out["card_kernel_launches"].values()) == 0 or any(
            out["cpu_kernel_launches"].values()):
        fail(f"{path}: the card run must launch the kernels and the CPU run "
             f"must not")


def profile_solve(torch, path, run, wall_s):
    """Device time by kernel over one solve; `wall_s` is the unprofiled
    median solve time, so busy / wall is the device's busy share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=60)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_{path}.txt"), "w") as f:
        f.write(table)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev_us(e))[:8]
    emit({"phase": "profile", "path": path, "device_busy_ms": busy_ms,
          "device_launches": sum(e.count for e in kernels),
          "busy_share_of_unprofiled_wall": busy_ms / 1e3 / wall_s,
          "top_kernels": [[e.key[:80], dev_us(e) / 1e3, e.count] for e in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, REPO)
    import ilqr_planner_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase_device_and_build()
    kv = phase_kernels_vs_twins(torch)
    e2e = {}
    e2e["flagship"] = phase_flagship(torch)
    for path in PATHS:
        e2e[path] = phase_new_path(torch, path)
    for path in e2e:
        phase_cross_check(torch, path)
    for path, (out, run) in e2e.items():
        profile_solve(torch, path, run, statistics.median(out["repeat_times_s"]))

    def row(name, src, replaces, kv_key, launches):
        k = kv[kv_key]
        return {"name": name, "route": "cuda",
                "source": f"ilqr_planner_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs_err_f64"],
                "max_abs_err_f32": k["max_abs_err_f32"],
                "ms": k["kernel_ms_f32"], "plain_ms": k["twin_ms_f32"],
                "ms_f64": k["kernel_ms_f64"], "plain_ms_f64": k["twin_ms_f64"],
                "bound_ms": k["bound_ms_f32"], "bound_by": k["bound_by"],
                "library_ms": None}

    pallas = "ilqr_planner_tpu/ops/pallas_kernels/"
    emit({"kernels": [
        row("segment_backward", "segment_backward.cu",
            pallas + "segment_backward.py:339", "segment_backward",
            e2e["flagship"][0]["launches"]["segment_backward"]),
        row("segment_backward_2nd", "segment_backward_2nd.cu",
            pallas + "segment_backward_2nd.py:255", "second",
            e2e["posorn2nd"][0]["launches"]["segment_backward_2nd"]),
        row("segment_backward_time1", "segment_backward_2nd.cu",
            pallas + "segment_backward_2nd.py:270", "time1",
            e2e["timeopt"][0]["launches"]["segment_backward_time1"]),
        row("rollout_time1", "rollout_time1.cu", pallas + "rollout_time1.py:169",
            "rollout_time1", e2e["timeopt"][0]["launches"]["rollout_time1"])],
        "total_s": time.time() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
