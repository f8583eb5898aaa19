"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel of the main path with its ptxas register/spill report;
  2. each kernel against its plain PyTorch twin at the flagship's shapes,
     float64 (the correctness gate) and float32, with CUDA-event timings and
     the least time the card could take (bytes or operations bound);
  3. the flagship fleet solve end to end through
     `ilqr_planner_torch.parallel.solve_batch` (7-DoF Panda, position +
     quaternion via-points at steps 49 and 99, H=100, dt=0.1, 10 iterations,
     float32, B=36864), with the kernel launch counts of that run;
  4. the same batch's first 64 lanes in float64, on the card and on the CPU
     (where the backward runs the twin): same iterations and alpha per lane,
     cost within 1e-8 relative;
  5. a torch.profiler trace of one flagship solve: device busy time, its
     share of the unprofiled wall time, the top kernels (the full table
     goes to chiprun_out/profile_solve.txt).
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

F64_REL_GATE = 1e-9       # kernel vs twin, float64 (only reduction order)
XCHECK_REL = 1e-8         # card vs CPU final cost, float64


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def flagship_spec(torch, dtype, device):
    from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", dtype=dtype,
                                             device=device))
    prec = np.diag([1, 1, 1, .1, .1, .1])
    kps = [PosOrnKeypoint(*T1, prec, 49), PosOrnKeypoint(*T2, prec, 99)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn", robot, kps, np.ones(7) * 1e-5, H, 1, dt=0.1,
                     q0=Q0, q_max=qmax, q_min=-qmax, dtype=dtype,
                     device=device)


def flagship_batch(batch):
    rng = np.random.default_rng(0)
    q0s = Q0[None, :] + 0.05 * rng.normal(size=(batch, 7))
    return q0s, np.zeros((batch, H - 1, 7))


def sweep_inputs(seed=0):
    """Seeded sweep inputs at the flagship shapes, scaled like the solve's:
    SPD terminal and keypoint Hessians, positive limit diagonal."""
    rng = np.random.default_rng(seed)

    def spd(*lead):
        A = rng.normal(size=lead + (N, N, B)).astype(np.float32)
        return np.einsum("...ikb,...jkb->...ijb", A, A) / N

    L2 = rng.uniform(0.5, 1.5, size=(H - 1, N, B))
    return (spd() + np.eye(N)[:, :, None], rng.normal(size=(N, B)), L2,
            rng.normal(size=(H - 1, N, B)),
            0.1 * rng.normal(size=(H - 1, N, B)), spd(len(KP_INNER)))


def sweep_flops(n, hm1, n_kp, batch):
    """Operations of one sweep, counted from the kernel's loops (each add,
    multiply, divide or square root one)."""
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


def sweep_bytes(n, hm1, n_kp, batch, itemsize):
    """Each input read once, each output written once; the kernel reads only
    the upper triangles of P0 and of each keypoint Hessian gxx."""
    tri = n * (n + 1) // 2
    vals = (tri + n + 3 * hm1 * n + n_kp * tri         # P0, p0, L2/lx/U, gxx
            + hm1 * n * n + hm1 * n)                    # Ks, ds
    return batch * vals * itemsize + hm1 * 4 + (2 + n) * itemsize


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


def phase_device_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb

    t0 = time.time()
    lib, ptxas = sb.build()
    build_s = time.time() - t0
    report = [ln.strip() for ln in ptxas.splitlines()
              if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvidia_smi": smi, "build_s": build_s,
          "library": os.path.relpath(lib, REPO), "ptxas": report})


def phase_kernel_vs_twin(torch):
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb

    args_np = sweep_inputs()
    out = {"phase": "kernel_vs_twin", "name": "segment_backward",
           "shapes": {"n": N, "H": H, "B": B, "kp_inner": KP_INNER}}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in args_np]
        call = (lambda a=args: sb.segment_backward(*a, KP_INNER, 0.1,
                                                   [1e-5] * N))
        twin = (lambda a=args: sb.segment_backward_reference(*a, KP_INNER, 0.1,
                                                             [1e-5] * N))
        K, d = call()
        torch.cuda.synchronize()
        K_ref, d_ref = twin()
        torch.cuda.synchronize()
        abs_err = max(float((K - K_ref).abs().max()), float((d - d_ref).abs().max()))
        scale = max(float(K_ref.abs().max()), float(d_ref.abs().max()))
        finite = bool(torch.isfinite(K).all()) and bool(torch.isfinite(d).all())
        del K, d, K_ref, d_ref
        out[f"max_abs_err_{tag}"] = abs_err
        out[f"max_rel_err_{tag}"] = abs_err / scale
        out[f"finite_{tag}"] = finite
        out[f"kernel_ms_{tag}"] = cuda_ms(torch, call)
        out[f"twin_ms_{tag}"] = cuda_ms(torch, twin, reps=10, warm=1)
        del args
        torch.cuda.empty_cache()
    flops = sweep_flops(N, H - 1, len(KP_INNER), B)
    nbytes = sweep_bytes(N, H - 1, len(KP_INNER), B, 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    out.update({"bytes_f32": nbytes, "flops": flops,
                "bound_ms_f32": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "library_note": "no single PyTorch call computes the sweep"})
    emit(out)
    if not (out["finite_f64"] and out["finite_f32"]):
        fail("kernel output not finite")
    if out["max_rel_err_f64"] > F64_REL_GATE:
        fail(f"kernel vs twin float64 relative error {out['max_rel_err_f64']} "
             f"> {F64_REL_GATE}")
    return out


def phase_end_to_end(torch):
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.parallel import mesh, solve_batch
    from ilqr_planner_torch.solvers.fleet import make_fleet_solver

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = flagship_batch(B)
    q0s_t = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    U0s_t = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    ov = {"q0": q0s_t, "x0": q0s_t}

    torch.cuda.synchronize()
    sb.LAUNCHES = 0
    t0 = time.time()
    res = solve_batch(spec, ov, U0s_t, NB_ITER)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = sb.LAUNCHES
    sweeps = int(res.iterations.max())

    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        res = solve_batch(spec, ov, U0s_t, NB_ITER)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    cost = res.cost.double().cpu().numpy()
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
    out = {"phase": "end_to_end", "batch": B, "nb_iter": NB_ITER,
           "dtype": "float32", "first_call_s": first_s,
           "memo_hit_ms": 1e3 * statistics.median(fp_s),
           "memo_miss_extra_ms": 1e3 * statistics.median(build_s),
           "repeat_times_s": times,
           "solves_per_s_median": B / statistics.median(times),
           "spread_max_over_min": max(times) / min(times),
           "median_cost": float(np.median(cost)),
           "converged_frac": float(np.mean(cost < 1e-4)),
           "median_iterations": float(np.median(res.iterations.cpu().numpy())),
           "segment_backward_launches": launches, "backward_sweeps": sweeps,
           "shapes_ok": (tuple(res.X.shape) == (B, H, N)
                         and tuple(res.U.shape) == (B, H - 1, N)
                         and tuple(res.fX.shape) == (B, H, 7)),
           "finite": bool(torch.isfinite(res.X).all()
                          and torch.isfinite(res.U).all())}
    emit(out)
    if not out["shapes_ok"] or not out["finite"]:
        fail("end-to-end result has the wrong shape or non-finite values")
    if not math.isfinite(out["median_cost"]):
        fail("median cost is not finite")
    if out["converged_frac"] < 0.95:
        fail(f"converged fraction {out['converged_frac']} < 0.95")
    if launches == 0 or launches != sweeps:
        fail(f"segment_backward launched {launches} times for {sweeps} sweeps")
    return out, spec, ov, U0s_t


def phase_cross_check(torch):
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.solvers.fleet import make_fleet_solver

    q0s, U0s = flagship_batch(B)
    q0s, U0s = q0s[:64], U0s[:64]
    before = sb.LAUNCHES
    gpu = make_fleet_solver(flagship_spec(torch, torch.float64, "cuda"),
                            NB_ITER)(q0s, U0s)
    torch.cuda.synchronize()
    gpu_launches = sb.LAUNCHES - before
    cpu = make_fleet_solver(flagship_spec(torch, torch.float64, "cpu"),
                            NB_ITER)(q0s, U0s)
    c_gpu, c_cpu = gpu.cost.cpu().numpy(), cpu.cost.numpy()
    rel = float(np.max(np.abs(c_gpu - c_cpu) / np.abs(c_cpu)))
    same_it = bool(np.array_equal(gpu.iterations.cpu().numpy(),
                                  cpu.iterations.numpy()))
    same_alpha = bool(np.array_equal(gpu.alpha.cpu().numpy(), cpu.alpha.numpy()))
    out = {"phase": "card_vs_cpu", "batch": 64, "dtype": "float64",
           "same_iterations": same_it, "same_alpha": same_alpha,
           "cost_max_rel_diff": rel, "tolerance": XCHECK_REL,
           "card_kernel_launches": gpu_launches, "cpu_kernel_launches":
           sb.LAUNCHES - before - gpu_launches,
           "U_max_abs_diff": float((gpu.U.cpu() - cpu.U).abs().max())}
    emit(out)
    if not (same_it and same_alpha and rel <= XCHECK_REL):
        fail("card and CPU disagree")
    if gpu_launches == 0 or out["cpu_kernel_launches"] != 0:
        fail("the card run must launch the kernel and the CPU run must not")


def profile_solve(torch, spec, ov, U0s_t, wall_s):
    """Device time by kernel over one flagship solve; `wall_s` is the
    unprofiled median solve time, so busy / wall is the device's busy share."""
    from ilqr_planner_torch.parallel import solve_batch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solve_batch(spec, ov, U0s_t, NB_ITER)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=60)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_solve.txt"), "w") as f:
        f.write(table)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev_us(e))[:6]
    emit({"phase": "profile", "device_busy_ms": busy_ms,
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
    kv = phase_kernel_vs_twin(torch)
    e2e, spec, ov, U0s_t = phase_end_to_end(torch)
    phase_cross_check(torch)
    profile_solve(torch, spec, ov, U0s_t,
                  statistics.median(e2e["repeat_times_s"]))
    emit({"kernels": [{
        "name": "segment_backward", "route": "cuda",
        "source": "ilqr_planner_torch/csrc/segment_backward.cu",
        "replaces": "ilqr_planner_tpu/ops/pallas_kernels/segment_backward.py:339",
        "launches": e2e["segment_backward_launches"],
        "max_abs_err": kv["max_abs_err_f64"],
        "max_abs_err_f32": kv["max_abs_err_f32"],
        "ms": kv["kernel_ms_f32"], "plain_ms": kv["twin_ms_f32"],
        "bound_ms": kv["bound_ms_f32"], "bound_by": kv["bound_by"],
        "library_ms": None}], "total_s": time.time() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
