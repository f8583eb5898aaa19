"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Fourteen paths (and six more below, since the per-lane leaves and the
sharded solves), each through `ilqr_planner_torch.parallel.solve_batch`
(al_h400: `solve_batch_al_staged`; batch_gn, batch_cp: `solve_batch_gn`),
float32:
  flagship   position + quaternion via-points at steps 49 and 99, H=100,
             dt=0.1, 10 iterations, B=36864, 7-DoF Panda (backward:
             segment_backward);
  recursive  the flagship's problem and its first 4096 lanes through
             solve_batch(prefer_fleet=False): the recursive solver, dense
             stage terms at every step (backward: riccati);
  posorn2nd  the double integrator, via-points with velocity targets at
             199 and 399, H=400, dt=0.01, 15 iterations, B=4096
             (backward: segment_backward_2nd);
  timeopt    the sqrt-dt time-optimal kind, spacetime via-points at 49
             (t=2) and 99 (t=5), H=100, 20 iterations, B=2048 (backward:
             segment_backward_time1; every line-search trial: rollout_time1);
  flagship_ov  the flagship with per-lane overrides of the targets (moved
             by N(0, 0.02 m)), the step-99 precision (scaled by U(1, 1.5)),
             the step-49 dead-zone radius (U(0, 0.01) m) and the
             orientation thresholds (zeros), record=True, B=36864;
  sequential_h600  two object frames (a sequential spec), targets at 300
             and 599, H=600, dt=0.01, 10 iterations, B=1024 (segment_backward
             at H=600);
  planar2d   a 3-link planar arm, position targets at 49 and 99, H=100, 10
             iterations, B=4096 (segment_backward at n=3);
  sequential_h600_recursive, hybrid_h500_recursive, planar2d_recursive
             sequential_h600, the hybrid joint + position/orientation spec
             (H=500, B=8192) and planar2d through solve_batch(prefer_fleet=
             False) (riccati at (7, 12), (7, 13) and (3, 2));
  al_h400    AL-iLQR: posorn, keypoints at 199 and 399, H=400, dt=0.01,
             the bound x5 <= 2 (a 14-row A, 13 rows zero), duals from b,
             100 iterations staged (first stage 45, buckets of 512), B=8192
             (the bound folds into the stage rows: segment_backward at
             H=400);
  timeopt2nd the time-optimal double integrator of the reference tutorial:
             spacetime keypoints at 24 (t=2.5) and 49 (t=5), H=50, 10
             iterations, B=2048 (the fleet's generic sweep and rollout in
             tensor ops: no kernel; most lanes diverge to NaN, as the
             reference notebook does);
  batch_gn, batch_cp  the batch Gauss-Newton solver through
             `parallel.solve_batch_gn` (bench_table.py:202-235, uncut): the
             flagship problem, B=4096, 10 iterations, q0 = Q0 + 0.05 N(0, 1)
             (seed 0), u0 = 0; batch_cp with the unit-step primitives
             kron(unitstep(99, 2), I7) (no kernel: dense library calls, as
             in the JAX package);
  overrides_f5_all_leaves, overrides_f5_limits_mask  the recursive path's
             problem (B=4096) with per-lane Rt (log-uniform 1e-6 to 1e-4),
             dt (U(0.08, 0.12)), the Panda's joint limits shrunk by U(0,
             0.3) of each lane's range, penalty (U(0.5, 2)) and the step-49
             keypoint off on every odd lane (seed 12): every leaf (a per-lane
             Rt and dt take the generic recursion: riccati 0 launches), then
             the limit leaves and the mask alone (riccati once a sweep);
  sharded_flagship, sharded_recursive, chunked_recursive
             `parallel.solve_batch_sharded` on a one-rank mesh (the
             flagship, B=36864, and the recursive path, B=4096) and
             `solve_batch_chunked` on the recursive path in chunks of 1024;
  fleet_step `parallel.spmd.fleet_step` on a 1 x 1 (dp, sp) mesh, B=4096.

Phases (each prints one JSON line; any failure exits non-zero):
  1. device and build: the card's name and power limit; the nvcc build of
     every kernel at every width the checks run (one library a kernel and
     width), all started together, with each ptxas register/spill report,
     under a CompileMeter (`utils.compilemeter`: its nvcc runs are the
     libraries absent before the build, nvcc_s within the wall, other_s >=
     0); then a `calibration` line, the fixed probe's time
     (`utils.calibprobe`) beside its nominal time and their ratio, printed
     again after the last phase (no speed gate);
  2. each kernel against its plain PyTorch twin at its path's shapes,
     float64 (the correctness gate, 1e-9 relative) and float32, with
     CUDA-event timings and the least time the card could take (bytes or
     operations bound), and its launch (blocks, threads a block, shared
     memory, lanes an SM) held against the built library's; each kernel
     also at ragged batches (below one block's lanes; not a multiple of
     them) on a short horizon, with keypoints (precisions) at the first and
     the last step; riccati also at its joint (nq=7) and point (nq=3)
     widths; and each kernel at the widths of a 6-DoF chain
     (segment_backward also at n=3; riccati at (6, 6) and (6, 3)); riccati
     at the sequential specs' (7, 12) H=600 and (7, 13) H=500 and the
     planar (3, 2), segment_backward at H=600 with inner keypoints at 0
     and 299 on a ragged batch and at the planar n=3, and at al_h400's
     H=400, B=8192 with the folded bound in its streamed rows; the
     limit-penalty kernel at the bulk cells' shapes (posorn [100, 7,
     294912]: the cost of an affine trial read from the family [100, 2, 7,
     294912], the cost and the arrays of a trajectory; timeopt [100, 8,
     131072]: the cost and the arrays), its arrays bit for bit and its cost
     within H n nsub eps of the twin's on every lane, in both types;
  3. each path end to end (the flagship's first solve under a
     CompileMeter, its `first_call_split`: no nvcc run, at least one solver
     build, other_s >= 0; phase 2 has loaded every library, so it shows no
     load): a first solve with every launch count set to 0
     just before it and read just after (each kernel of the path must have
     launched: once per backward sweep, and for the rollout once per
     line-search trial plus once for the solve's initial rollout; the
     limit penalty's cost on the flagship, posorn2nd and timeopt once per
     trial plus once, its arrays once per sweep; no
     backward kernel of another path may have launched), then the median of
     2 timed repeats with the spread, solves/s, median cost and iterations;
     sequential_h600 and planar2d within 2x of the JAX package's float32
     median cost; the recursive runs of riccati once a backward sweep;
     flagship_ov's record ends at each lane's final cost, NaN
     beyond its last iteration, with the host time of binding its
     overrides; solve_batch_staged on flagship_ov's lanes (first stage 8
     of 10 iterations) against plain solve_batch (the same iterations,
     alpha, costs and U, bit for bit); al_h400 within 2x of the JAX
     record, segment_backward once a sweep of each stage and no generic
     sweep, with the bound's largest violation; timeopt2nd with no kernel
     launch, the generic sweep once an iteration, its NaN share; one
     generic sweep's device launches, profiled;
  4. each path's first 64 lanes in float64, on the card and on the CPU
     (where the wrappers run the twins): same iterations and alpha per lane,
     every lane's cost within 1e-8 relative, or within 10 times that lane's
     own CPU spread under a 1e-15 relative change of x0 (up or down) where
     the lane is that sensitive; and the recursive path against the fleet
     path on the card on the same 64 lanes, cost within 1e-8 relative; and 64 lanes of
     a joint-target problem (nb_deriv 1, the riccati kernel at nq=7)
     through the recursive solver on the card and on the CPU, float64, same
     iterations and alpha per lane, every lane's cost within 1e-8 relative;
     and 64 lanes of the flagship's problem on a 6-DoF chain (panda_link0
     to panda_link6) through the fleet on the card and on the CPU, under the
     paths' gates; and 64 lanes of flagship_ov (with all four overrides,
     whose per-lane precisions take the recursive route's generic sweep,
     and with three, which keep riccati), sequential_h600 (riccati at
     nq=12), a sequential spec with a per-subsystem list override,
     planar2d (riccati at (3, 2)) and the hybrid joint + position/
     orientation spec of H=500 (riccati at nq=13), each on the fleet and on
     the recursive route, card against CPU, and the two routes against each
     other on the card (the same per-lane rule, on the larger of the two
     routes' CPU spreads: the routes round otherwise, and on the CPU their
     gap stays within 3.2x that spread on every lane of five batches,
     `tools/route_gap.py`); and record=True on the recursive route (riccati)
     and in ilqr.solve, card against CPU, 64 lanes, float64; and 64 lanes
     of al_h400's problem (12 iterations, two dual updates) on the fleet
     and the recursive route and the two against each other, the coupled
     bound x4 + x5 <= 2 on the fleet (the generic sweep with the AL
     terms), and the time-optimal double integrator (posorn_time and
     joint_time, the JAX package's test problems at H=50) on the fleet
     after one iteration without line search (every lane within 1e-9) and
     four with;
  5. one line, no gate: at B=4096, the dense input assembly and the riccati
     kernel beside the fleet's keypoint-sparse assembly and segment_backward;
  6. two lines, no gate: the riccati kernel against its twin at inputs
     harder than phase 2's (the limit penalty live on 5% and 20% of the
     entries), beside the twin against an LU recursion on the same inputs;
  7. a torch.profiler trace of a window of each path's solve but
     planar2d's, timeopt2nd's and the recursive slice runs (its initial
     rollout and first two iterations, each a backward sweep and a line
     search): device busy time, its share of the window's unprofiled wall
     time, the top kernels, and the device time a launch of the path's
     hand-written kernels on the solve's own data (the full table goes to
     chiprun_out/profile_<path>.txt).
  8. (no hand-written kernel on these paths) batch_gn and batch_cp
     at full width: one warm-up, 3 timed repeats, solves/s with the
     spread, median cost and iterations, within 2x of the JAX record
     (BENCH_TABLE.json), no kernel launch, and one profiled solve's
     launches and device busy share; 64 lanes of each in float64 card
     against CPU (the per-lane rule of phase 4, u within 1e-8 of max |u|),
     the reference-shaped body card against CPU and against the
     closed-form body on the card (1e-8), posorn_time at nb_deriv 1 (GN
     and CP, early stop off) card against CPU with u within 1e-6 or the
     lane's own spread; lqt_h400 (LQT on the 7-joint double integrator,
     N=400): solve_dp, solve_dp(parallel=True) and solve_linalg card
     against CPU at 1e-9 in float64, the two DPs within 1e-8 of each
     other, their walls; ilqr.solve(backward='pscan') on the golden and
     the time-optimal problems of the JAX package's test_pscan.py, card
     against CPU in float64 (cost 1e-8 or the spread rule, equal
     iterations), pscan against scan on the card within that test's
     tolerances, riccati launched by the scan route only, and both routes'
     float32 walls.
  9. pylqr: the reference's PyLQR API (`ilqr_planner_torch.compat`) on the
     card in float64, as the tutorial scripts call it: POS_ORN_SYS
     (ILQRRecursive with a MetricsCallback: the notebook's 8 costs at rtol
     2e-4, riccati once an iteration and no other kernel, X, U and cost
     within 1e-9 relative of the same solve on the CPU; the solve's host
     syncs under torch.cuda.set_sync_debug_mode: without a callback exactly
     the solver loop's own reads, with one a read more an iteration; two
     threaded solves, each callback hearing only its own iterations),
     BatchILQR and BatchILQRCP with callbacks (u within 1e-8 of max |u|
     of the CPU's, the first CP cost 0.506613; the closed-form body's host
     syncs equal at 2 and 10 iterations), the send_vel replay through the
     via-points, guard=True (8 iterations ending at 9.80374e-07, never
     above the unguarded cost); POS_ORN_SYS_AL_ILQR at H=400 (max x5 <=
     2.01, the plain cost card vs CPU within 1e-8 or the spread rule);
     POS_ORN_TIME_SYS_2ND at H=50 with guard=True (finite, <= 2.91514, <=
     the one-iteration guarded cost; the unguarded NaN state reported);
     POS_ORN_MULTI_SYS (a SequentialSystem over two object frames, H=600:
     riccati at (7, 12) once an iteration, card vs CPU 1e-9); and riccati
     at B=1, the batch of every such solve, against its twin.
 10. overrides_f5: the two overrides_f5 paths end to end (counts at 0 just
     before each first solve, 2 timed repeats; riccati 0 launches with every
     leaf, once a sweep with the limits and mask; no fleet kernel); then 64
     lanes of each, of solve_batch_al (x5 <= 1.5, 12 iterations) and of
     solve_batch_gn with per-lane Rt, dt and state_max, float64 card against
     CPU under phase 4's per-lane rule.
 11. sharded: solve_batch_sharded at world size 1, the flagship bit for bit
     the flagship's solve_batch (segment_backward once a sweep) and the
     recursive route bit for bit solve_batch(prefer_fleet=False) (riccati
     once a sweep), no torch.distributed collective called;
     solve_batch_chunked on the recursive path (chunks of 1024) each lane
     bit for bit the unchunked solve's, riccati the sum of the chunks'
     sweeps, with the peak memory of each (torch.cuda.max_memory_allocated
     over the memory before it); solves/s of each, 2 timed repeats.
 12. spmd: solve_batch_sp at world size 1 on the batch_gn problem's first
     scenario (float64) against batch.solve on the card (u within 1e-9 of
     max |u|, cost rtol 1e-9, the same iterations); fleet_step on a 1 x 1
     mesh at B=4096, its costs bit for bit the fleet's, segment_backward
     once a sweep, no collective.
Then the kernel table and, last, {"ok": true, "device": {...}}. Every JSON
line also goes to chiprun_out/chip_smoke.jsonl.

It needs one card, and the repository it sits in; without either it fails
before printing any result.
"""

import contextlib
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
H, N, B, NB_ITER, REPEATS = 100, 7, 36864, 10, 2
KP_INNER = (49,)          # the terminal keypoint (99) folds into P0
QD6 = [1, 1, 1, .1, .1, .1]
NQ = 6                    # residual width of the position + quaternion kind
REC_B = 4096              # the recursive path's batch

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
# Card vs CPU final cost, float64, every lane: within 1e-8 relative, or, in
# a sensitive solve, within 10 times the lane's own CPU spread when its x0
# moves by 1e-15 relative (up or down), whichever is larger. The
# time-optimal solve amplifies rounding: on the CPU alone that 1e-15 change
# moves its 20-iteration cost by up to 5.6e-8, and the 6-DoF flagship's
# lane that does not converge by 2.1e-7 (PERF.md).
XCHECK_REL = 1e-8
XCHECK_SENS_FACTOR = 10.0
XCHECK_PERTURB = 1e-15
XCHECK_B = 64


# every line printed also goes to a file, so that a long run's full output
# survives where only the end of standard output is kept
LINES = os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl")


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LINES, "a") as f:
        f.write(line + "\n")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

def _panda(dtype, device, tip="panda_tip"):
    from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf

    return Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0", tip,
                                            dtype=dtype, device=device))


def flagship_spec(torch, dtype, device, dof=7):
    """The flagship's problem; at dof=6 on the Panda's first six joints
    (panda_link0 to panda_link6, a chain that is not the 7-DoF arm)."""
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    prec = np.diag(QD6)
    kps = [PosOrnKeypoint(*T1, prec, 49), PosOrnKeypoint(*T2, prec, 99)]
    qmax = np.ones(dof) * np.pi * 10
    robot = _panda(dtype, device, "panda_tip" if dof == 7 else f"panda_link{dof}")
    return make_spec("posorn", robot, kps, np.ones(dof) * 1e-5, H, 1, dt=0.1,
                     q0=Q0[:dof], q_max=qmax, q_min=-qmax, dtype=dtype,
                     device=device)


def flagship_batch(batch):
    rng = np.random.default_rng(0)
    q0s = Q0[None, :] + 0.05 * rng.normal(size=(batch, 7))
    return q0s, np.zeros((batch, H - 1, 7))


def recursive_batch(batch):
    """The first `batch` lanes of the flagship batch."""
    q0s, U0s = flagship_batch(B)
    return q0s[:batch], U0s[:batch]


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
    sign flips of K and d counted too; each Qux column formed once)."""
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
        value += 5 * m + qx + 3
        for j in range(i, n):
            if second:
                qxx = 1 + pa(j) if i < dof else 3 + 2 * pa(j)
            else:
                qxx = 1
            value += 5 * m + qxx + 3
    per_step = system + gauss + gains + value
    return batch * (hm1 * per_step + n_kp * n * (n + 1) // 2)


def rollout_inputs(n, hm1, batch):
    """Seeded rollout inputs -> (Ks, ds, Xref, Uref, x0): a reference
    trajectory that drifts like a solve's, step controls s in [0.05, 0.1)."""
    rng = np.random.default_rng(2)
    Xref = np.cumsum(np.concatenate([0.05 * rng.normal(size=(1, n, batch)),
                                     0.02 * rng.normal(size=(hm1, n, batch))]), 0)
    Uref = 0.05 * rng.normal(size=(hm1, n, batch))
    Uref[:, -1] = 0.05 + 0.05 * np.abs(Uref[:, -1])
    return (0.1 * rng.normal(size=(hm1, n, n, batch)),
            0.05 * rng.normal(size=(hm1, n, batch)), Xref, Uref, Xref[0].copy())


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


# The residual precisions of the riccati kernel's widths: position +
# quaternion (the flagship's), joint, point.
PREC_DIAG = {6: QD6, 7: [1.0] * 7, 3: [1.0] * 3}


def riccati_inputs(batch, limit_frac=0.005, seed=0, nq=NQ, h=H, n=N):
    """Seeded inputs of the dense Riccati sweep at horizon h, width (n, nq):
    Jacobians and residuals at every step, the limit penalty live on a share
    `limit_frac` of the entries (a solve's limits are rarely active, and
    every active step amplifies the recursion's rounding: 0.5% is the
    checks' share) -> (J, e, ld, lq, u)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(batch, h, nq, n)) * 0.3
    e = rng.normal(size=(batch, h, nq)) * 0.05
    ld = (rng.uniform(size=(batch, h, n)) < limit_frac).astype(float)
    lq = ld * rng.normal(size=(batch, h, n)) * 0.1
    u = rng.normal(size=(batch, h - 1, n)) * 0.1
    return J, e, ld, lq, u


def riccati_prec(dense, weight=None, nq=NQ, h=H, steps=None):
    """Precisions [h, nq, nq]: the width's at `steps` (the flagship's H/2
    and H-1 unless given), or times `weight` (1e-4 unless given) at every
    step. (Unit precisions at all 100 steps keep dt^2 P far above Rt, where
    the recursion doubles the antisymmetric rounding residue of P every step
    and the port's twin leaves float64; a tracking weight small against
    Rt / dt^2 does not.)"""
    prec = np.zeros((h, nq, nq))
    if dense:
        prec[:] = (1e-4 if weight is None else weight) * np.diag(PREC_DIAG[nq])
    else:
        prec[list(steps or (h // 2, h - 1))] = (
            (1.0 if weight is None else weight) * np.diag(PREC_DIAG[nq]))
    return prec


def riccati_lu_sweep(torch, J, ld, prec, Rt=1e-5, dt=0.1, reg=1e-6):
    """The gains of the dense sweep by the same recursion with an LU solve
    (`torch.linalg.solve`) in place of the explicit Gauss-Jordan inverse
    -> (K [B, H-1, N, N], the largest |P - P'| entry seen along the sweep).
    Another order of the same sums: how far it lands from the twin says how
    much the recursion amplifies rounding on these inputs."""
    eye = torch.eye(N, dtype=J.dtype, device=J.device)
    Jt = J.transpose(-1, -2)
    lxx = Jt @ (prec @ J) + torch.diag_embed(ld * ld)
    P = lxx[:, H - 1]
    K = torch.empty((J.shape[0], H - 1, N, N), dtype=J.dtype, device=J.device)
    asym = 0.0
    for t in range(H - 2, -1, -1):
        Mr = dt * dt * P + (Rt + reg) * eye
        Qux = dt * P
        Kt = -torch.linalg.solve(Mr, Qux)
        KT = Kt.transpose(-1, -2)
        P = (lxx[:, t] + P + KT @ (Mr - reg * eye) @ Kt + KT @ Qux
             + Qux.transpose(-1, -2) @ Kt)
        K[:, t] = Kt
        a = float((P - P.transpose(-1, -2)).abs().max())
        asym = max(asym, a) if math.isfinite(a) else float("inf")
    return K, asym


def rel_diff(a, b):
    """max |a - b| / max |b|, or None where either holds a non-finite
    value."""
    if not (bool(a.isfinite().all()) and bool(b.isfinite().all())):
        return None
    return float((a - b).abs().max()) / float(b.abs().max())


def riccati_flops(n, nq, h, batch):
    """Operations of one dense sweep, counted from the loops of
    csrc/riccati.cu (each add, multiply, divide or sign flip one): the stage
    terms at all h steps, the recursion at h - 1."""
    dot = 2 * nq - 1
    stage = nq * n * dot + nq * dot + n * n * dot + 2 * n + n * (dot + 3)
    system = n * n + 2 * n + 3 * n + n
    gauss = n * (1 + 2 * n + 4 * n * (n - 1))
    gains = n * (n + n * (3 * n - 1) + 2 * n - 1)
    ktq = n * n * (3 * n + 2)
    value = n * n * (8 * n + 1) + n * 7 * n
    return batch * (h * stage + (h - 1) * (system + gauss + gains + ktq + value))


def riccati_bytes(n, nq, h, batch, itemsize):
    """Each input read once (J, e, ld, lq, u, prec, parameters), each output
    written once (K, d)."""
    vals = h * (nq * n + nq + 2 * n) + (h - 1) * n + (h - 1) * (n * n + n)
    return (batch * vals + h * nq * nq + 2 + n) * itemsize


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bytes_f32": nbytes, "flops": flops,
            "bound_ms_f32": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this recursion"}


def cuda_ms(torch, fn, reps=10, warm=2, inner=1):
    """Median CUDA-event time of fn() in ms over `reps` timed runs of `inner`
    calls back to back (inner > 1 for a kernel of tens of microseconds: with
    one call between the events, the host's time to enqueue it counts)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from ilqr_planner_torch.ops.cuda_kernels import (limit_penalty,
                                                     nvcc_build, riccati,
                                                     rollout_time1,
                                                     segment_backward,
                                                     segment_backward_2nd)
    from ilqr_planner_torch.utils.compilemeter import CompileMeter

    # every width the checks below run: one library a kernel and width
    widths = {**{f"segment_backward n={n}": (segment_backward, (n,)) for n in (7, 6, 3)},
              **{f"{kind} dof={d}": (segment_backward_2nd, (kind, d))
                 for kind in ("second", "time1") for d in (7, 6)},
              **{f"rollout_time1 n={n}": (rollout_time1, (n,)) for n in (8, 7)},
              **{f"riccati {n}x{nq}": (riccati, (n, nq))
                 for n, nq in ((7, 6), (7, 7), (7, 3), (6, 6), (6, 3), (7, 12),
                               (7, 13), (3, 2))},
              "limit_penalty": (limit_penalty, ())}
    # the libraries already built: the build below compiles every other one
    present = set(nvcc_build.BUILD_DIR.glob("*.so"))
    meter = CompileMeter()
    t0 = time.perf_counter()
    with meter, ThreadPoolExecutor(len(widths)) as ex:  # one nvcc per library
        built = list(ex.map(lambda w: w[0].build(*w[1]), widths.values()))
    build_s = time.perf_counter() - t0
    absent = sum(lib not in present for lib, _ in built)
    split = meter.report(wall_s=build_s)
    emit({"phase": "build", "nvidia_smi": smi, "build_s_all_parallel": build_s,
          "libraries_absent_before": absent, "first_call_split": split,
          "libraries": {label: {
              "source": os.path.relpath(mod.SOURCE, REPO),
              "library": os.path.relpath(lib, REPO),
              "ptxas": nvcc_build.ptxas_summary(report)}
              for (label, (mod, _)), (lib, report) in zip(widths.items(), built)}})
    if split["compiles"] != absent:
        fail(f"build: the meter counted {split['compiles']} nvcc runs for "
             f"{absent} libraries absent before the build")
    if not split["nvcc_s"] <= build_s or split["other_s"] < 0:
        fail(f"build: nvcc_s {split['nvcc_s']} over the wall {build_s} or "
             f"other_s {split['other_s']} < 0")


def phase_calibration(torch, when):
    """The fixed calibration probe's time on this card and host, beside its
    nominal time: speed factor = nominal / calib_s. No speed gate."""
    from ilqr_planner_torch.utils.calibprobe import (CALIB_NOMINAL_S,
                                                     calibration_probe)

    calib_s = calibration_probe()
    emit({"phase": "calibration", "when": when, "calib_s": calib_s,
          "calib_nominal_s": CALIB_NOMINAL_S,
          "speed_factor": CALIB_NOMINAL_S / calib_s,
          "device": torch.cuda.get_device_name(0)})
    if not (math.isfinite(calib_s) and calib_s > 0):
        fail(f"calibration ({when}): calib_s {calib_s} is not finite and "
             f"positive")


def _kernel_vs_twin(torch, name, shapes, args_np, call, twin, twin_reps,
                    inner=1):
    """Hold call(*args) against twin(*args) in float64 (gate) and float32;
    unless twin_reps is 0, CUDA-event ms of each, the kernel's over runs of
    `inner` calls back to back and, where inner > 1, of one call too (one
    call between two events counts the host's time in the wrapper, which a
    run of calls hides behind the kernels once they are longer than it)."""
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
        if twin_reps:
            out[f"kernel_ms_{tag}"] = cuda_ms(torch, lambda: call(*args),
                                              inner=inner)
            if inner > 1:
                out[f"kernel_ms_one_launch_{tag}"] = cuda_ms(
                    torch, lambda: call(*args))
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


def _launch_of(torch, name, planned, built):
    """The launch of a kernel in both types: what the wrapper plans
    (`launch_geometry`: needs no card) beside what the built library says
    (`kernel_geometry`: its own constants, and the resident blocks an SM by
    the CUDA occupancy calculator). Fails where the two disagree."""
    launch = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        plan, lib = planned(dtype), built(dtype)
        if any(plan[k] != lib[k] for k in ("blocks", "threads", "smem_bytes")):
            fail(f"{name}: the wrapper plans the launch {plan}, the library "
                 f"launches {lib}")
        resident = lib["resident_blocks_per_sm"]
        launch[tag] = {**plan, "resident_blocks_per_sm": resident,
                       "lanes_per_sm_resident": resident * plan["lanes_per_block"]}
    return launch


# Ragged batches for the kernels that run several threads a lane: below one
# block's 32 lanes, and the path's batch plus 37; a short horizon.
RAGGED_HM1 = 12


def phase_kernels_vs_twins(torch):
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2

    res = {}
    out = _kernel_vs_twin(
        torch, "segment_backward", {"n": N, "H": H, "B": B, "kp_inner": KP_INNER},
        sweep_inputs(N, N, H - 1, len(KP_INNER), B),
        lambda *a: sb.segment_backward(*a, KP_INNER, 0.1, [1e-5] * N),
        lambda *a: sb.segment_backward_reference(*a, KP_INNER, 0.1, [1e-5] * N),
        2, inner=5)
    out.update(bound(sweep_bytes(N, H - 1, len(KP_INNER), B, 4),
                     sweep_flops(N, H - 1, len(KP_INNER), B)))
    out["launch"] = _launch_of(torch, "segment_backward",
                               lambda dt_: sb.launch_geometry(B, dt_, N),
                               lambda dt_: sb.kernel_geometry(B, dt_, N))
    res["segment_backward"] = _gate_kernel(out)
    # ragged batches on a short horizon, keypoints at the first and the last
    # step; then the 6- and 3-DoF widths at the path's horizon
    edge = (0, RAGGED_HM1 - 1)
    for n, hm1, batch, kp in ((N, RAGGED_HM1, 45, edge), (N, RAGGED_HM1, B + 37, edge),
                              (6, H - 1, REC_B + 37, KP_INNER),
                              (3, H - 1, REC_B + 37, KP_INNER)):
        out = _kernel_vs_twin(
            torch, "segment_backward", {"ragged": n == N, "n": n, "H": hm1 + 1,
                                        "B": batch, "kp_inner": kp},
            sweep_inputs(n, n, hm1, len(kp), batch, seed=3),
            lambda *a: sb.segment_backward(*a, kp, 0.1, [1e-5] * n),
            lambda *a: sb.segment_backward_reference(*a, kp, 0.1, [1e-5] * n), 0)
        if n != N:
            out["launch"] = _launch_of(
                torch, "segment_backward",
                lambda dt_: sb.launch_geometry(batch, dt_, n),
                lambda dt_: sb.kernel_geometry(batch, dt_, n))
        res[f"segment_backward_n{n}_b{batch}"] = _gate_kernel(out)

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
            2, inner=5)
        out.update(bound(sweep_bytes(n, hm1, len(kp), cfg["B"], 4, m),
                         sweep2_flops(kind, n, m, hm1, len(kp), cfg["B"])))
        out["launch"] = _launch_of(
            torch, name, lambda dt_: sb2.launch_geometry(kind, cfg["B"], dt_, 7),
            lambda dt_: sb2.kernel_geometry(kind, cfg["B"], dt_, 7))
        res[kind] = _gate_kernel(out)
        # the 6-DoF chain's width at the path's shape
        n6, m6 = sb2.widths(kind, 6)
        Rt6 = [1e-5] * m6
        out = _kernel_vs_twin(
            torch, name, {"kind": kind, "n": n6, "m": m6, "H": cfg["H"],
                          "B": cfg["B"], "kp_inner": kp},
            sweep_inputs(n6, m6, hm1, len(kp), cfg["B"], seed=5),
            (lambda *a: sb2.segment_backward_2nd(*a, kp, dt, Rt6)) if kind == "second"
            else (lambda *a: sb2.segment_backward_time1(*a, kp, Rt6)),
            lambda *a: sb2.segment_backward_2nd_reference(kind, *a, kp, dt, Rt6), 0)
        out["launch"] = _launch_of(
            torch, name, lambda dt_: sb2.launch_geometry(kind, cfg["B"], dt_, 6),
            lambda dt_: sb2.kernel_geometry(kind, cfg["B"], dt_, 6))
        _gate_kernel(out)

    # both kinds at ragged batches; keypoints at the first and the last step
    edge = (0, RAGGED_HM1 - 1)
    for kind, path, dt, name, cases in (
            ("second", "posorn2nd", 0.01, "segment_backward_2nd",
             ((45, edge), (PATHS["posorn2nd"]["B"] + 37, (5,)))),
            ("time1", "timeopt", None, "segment_backward_time1",
             ((45, edge), (PATHS["timeopt"]["B"] + 37, edge)))):
        n, m = sb2.widths(kind, 7)
        Rt = [1e-5] * m
        for batch, kp in cases:
            _gate_kernel(_kernel_vs_twin(
                torch, name, {"kind": kind, "ragged": True, "n": n, "m": m,
                              "H": RAGGED_HM1 + 1, "B": batch, "kp_inner": kp},
                sweep_inputs(n, m, RAGGED_HM1, len(kp), batch, seed=3),
                (lambda *a: sb2.segment_backward_2nd(*a, kp, dt, Rt))
                if kind == "second" else
                (lambda *a: sb2.segment_backward_time1(*a, kp, Rt)),
                lambda *a: sb2.segment_backward_2nd_reference(kind, *a, kp, dt,
                                                              Rt), 0))

    # the rollout is tens of microseconds, less than its wrapper takes on the
    # host: its device time is the profiled one in the kernel table
    cfg = PATHS["timeopt"]
    n, hm1, Bt = cfg["n"], cfg["H"] - 1, cfg["B"]
    out = _kernel_vs_twin(
        torch, "rollout_time1", {"n": n, "H": cfg["H"], "B": Bt, "alpha": 0.5},
        rollout_inputs(n, hm1, Bt), lambda *a: rt1.rollout_time1(0.5, *a),
        lambda *a: rt1.rollout_time1_reference(0.5, *a), 5, inner=10)
    out.update(bound(rollout_bytes(n, hm1, Bt, 4), rollout_flops(n, hm1, Bt)))
    out["launch"] = _launch_of(torch, "rollout_time1",
                               lambda dt_: rt1.launch_geometry(Bt, dt_, n),
                               lambda dt_: rt1.kernel_geometry(Bt, dt_, n))
    res["rollout_time1"] = _gate_kernel(out)
    for batch in (45, Bt + 37):
        _gate_kernel(_kernel_vs_twin(
            torch, "rollout_time1", {"ragged": True, "n": n, "H": RAGGED_HM1 + 1,
                                     "B": batch, "alpha": 0.5},
            rollout_inputs(n, RAGGED_HM1, batch),
            lambda *a: rt1.rollout_time1(0.5, *a),
            lambda *a: rt1.rollout_time1_reference(0.5, *a), 0))
    out = _kernel_vs_twin(      # the 6-DoF chain's width (n = 7)
        torch, "rollout_time1", {"n": n - 1, "H": cfg["H"], "B": Bt, "alpha": 0.5},
        rollout_inputs(n - 1, hm1, Bt), lambda *a: rt1.rollout_time1(0.5, *a),
        lambda *a: rt1.rollout_time1_reference(0.5, *a), 0)
    out["launch"] = _launch_of(torch, "rollout_time1",
                               lambda dt_: rt1.launch_geometry(Bt, dt_, n - 1),
                               lambda dt_: rt1.kernel_geometry(Bt, dt_, n - 1))
    _gate_kernel(out)

    # the dense Riccati sweep: the recursive path's batch and the flagship's,
    # precisions at two steps (the paths' own pattern) and at every step
    Rt = [1e-5] * N
    full = riccati_inputs(B)
    for batch in (REC_B, B):
        lanes = tuple(a[:batch] for a in full)
        for dense in (False, True):
            out = _kernel_vs_twin(
                torch, "riccati", {"n": N, "nq": NQ, "H": H, "B": batch,
                                   "prec_steps": H if dense else 2},
                lanes + (riccati_prec(dense),),
                lambda *a: ric.riccati_backward(*a, Rt, 0.1),
                lambda *a: ric.riccati_backward_reference(*a, Rt, 0.1), 2,
                inner=5)
            out.update(bound(riccati_bytes(N, NQ, H, batch, 4),
                             riccati_flops(N, NQ, H, batch)))
            if not dense:
                out["launch"] = _launch_of(
                    torch, "riccati", lambda dt_: ric.launch_geometry(batch, dt_, N, NQ),
                    lambda dt_: ric.kernel_geometry(batch, dt_, N, NQ))
            key = "riccati" + ("_dense" if dense else "") + (
                "" if batch == REC_B else f"_b{batch}")
            res[key] = _gate_kernel(out)

    # riccati at ragged batches on a short horizon, precisions at the first
    # and the last step; then the joint and point widths, and the 6-DoF
    # chain's posorn (= joint) and point widths, at the path's horizon
    h = RAGGED_HM1 + 1
    for batch in (45, REC_B + 37):
        _gate_kernel(_kernel_vs_twin(
            torch, "riccati", {"ragged": True, "n": N, "nq": NQ, "H": h,
                               "B": batch, "prec_steps": (0, h - 1)},
            riccati_inputs(batch, seed=3, h=h)
            + (riccati_prec(False, h=h, steps=(0, h - 1)),),
            lambda *a: ric.riccati_backward(*a, Rt, 0.1),
            lambda *a: ric.riccati_backward_reference(*a, Rt, 0.1), 0))
    for n, nq in ((N, 7), (N, 3), (6, 6), (6, 3)):
        Rt_n = [1e-5] * n
        out = _kernel_vs_twin(
            torch, "riccati", {"n": n, "nq": nq, "H": H, "B": REC_B + 37,
                               "prec_steps": 2},
            riccati_inputs(REC_B + 37, seed=4, nq=nq, n=n)
            + (riccati_prec(False, nq=nq),),
            lambda *a: ric.riccati_backward(*a, Rt_n, 0.1),
            lambda *a: ric.riccati_backward_reference(*a, Rt_n, 0.1), 0)
        out["launch"] = _launch_of(
            torch, "riccati", lambda dt_: ric.launch_geometry(REC_B + 37, dt_, n, nq),
            lambda dt_: ric.kernel_geometry(REC_B + 37, dt_, n, nq))
        _gate_kernel(out)
    return res


# The bulk benchmark cells' trajectories (benchmark/configs): n and B of
# posorn_h100.bulk and timeopt_h100.bulk, both at H = 100.
LIMIT_CELLS = {"posorn": (N, 294912), "timeopt": (8, 131072)}


def limit_penalty_inputs(torch, n, batch, dtype):
    """An affine line-search family [H, 2, n, batch] on the card (base Q0 +
    0.05 N(0, 1), direction 0.05 N(0, 1), seed 11; a time slot, n = 8, at 0)
    and one limited subsystem [1, 4, n] at Q0 +- 0.1, penalty 1, the time
    slot unweighted: about 5% of the base's entries bind, 7% of the trial's
    at alpha 0.5."""
    g = torch.Generator(device="cuda").manual_seed(11)
    fam = 0.05 * torch.randn((H, 2, n, batch), generator=g, dtype=dtype,
                             device="cuda")
    q = torch.zeros(n, dtype=dtype, device="cuda")
    q[:7] = torch.as_tensor(Q0, dtype=dtype)
    fam[:, 0] += q[:, None]
    weight = torch.ones_like(q)
    weight[7:] = 0.0
    table = torch.stack([q + 0.1, q - 0.1, weight, torch.ones_like(q)])
    return fam, table[None].contiguous()


def phase_limit_penalty(torch):
    """The limit-penalty kernel against its twins at the bulk cells' shapes,
    float64 and float32: the arrays form (lx, L2) bit for bit, the cost
    within H n nsub eps of the twin's on every lane (a sum of H n nsub
    non-negative terms in another order), its zero lanes exactly; each
    form's CUDA-event time beside the twin's and its bytes bound (each
    input read once, each output written once)."""
    from ilqr_planner_torch.ops.cuda_kernels import limit_penalty as lp

    res = {}
    for cell, (n, batch) in LIMIT_CELLS.items():
        N_el = H * n * batch
        # form -> (cost?, elements read, elements written)
        forms = {"cost": (True, N_el, batch), "arrays": (False, N_el, 2 * N_el)}
        if cell == "posorn":
            forms = {"cost_affine": (True, 2 * N_el, batch), **forms}
        outs = {form: {"phase": "kernel_vs_twin", "name": "limit_penalty",
                       "form": form, "shapes": {"H": H, "n": n, "B": batch,
                                                "nsub": 1}}
                for form in forms}
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            fam, table = limit_penalty_inputs(torch, n, batch, dtype)
            Xb, Xd = fam[:, 0], fam[:, 1]
            X = Xb.contiguous()
            calls = {
                "cost_affine": (lambda: (lp.limit_cost(Xb, Xd, 0.5, table=table),),
                                lambda: (lp.limit_cost_reference(
                                    Xb, Xd, 0.5, table=table),)),
                "cost": (lambda: (lp.limit_cost(X, table=table),),
                         lambda: (lp.limit_cost_reference(X, table=table),)),
                "arrays": (lambda: lp.limit_arrays(X, table=table),
                           lambda: lp.limit_arrays_reference(X, table=table))}
            tol = H * n * table.shape[0] * torch.finfo(dtype).eps
            for form, (is_cost, _, _) in forms.items():
                out, (kernel, twin) = outs[form], calls[form]
                got, want = kernel(), twin()
                torch.cuda.synchronize()
                out[f"max_abs_err_{tag}"] = max(float((g - w).abs().max())
                                                for g, w in zip(got, want))
                out[f"binding_share_{tag}"] = float((want[-1] != 0).double().mean())
                if is_cost:
                    zero = want[0] == 0
                    rel = ((got[0] - want[0]).abs() / want[0])[~zero]
                    out[f"max_lane_rel_err_{tag}"] = float(rel.max())
                    out[f"lane_rel_tol_{tag}"] = tol
                    held = (bool((got[0][zero] == 0).all())
                            and out[f"max_lane_rel_err_{tag}"] <= tol)
                else:
                    held = all(torch.equal(g, w) for g, w in zip(got, want))
                out[f"held_{tag}"] = held
                del got, want
                out[f"kernel_ms_{tag}"] = cuda_ms(torch, kernel, inner=5)
                out[f"twin_ms_{tag}"] = cuda_ms(torch, twin, reps=2, warm=1)
                out.setdefault("launch", {})[tag] = lp.launch_geometry(
                    "cost" if is_cost else "arrays", batch, dtype, H, n)
            del fam, table, Xb, Xd, X, calls
            torch.cuda.empty_cache()
        for form, (is_cost, reads, writes) in forms.items():
            out = outs[form]
            # a compare pair, the gap and its product with the weight, and
            # the sum or the two accumulations, an element; the trial's
            # x = xb + alpha xd two more
            flops = (6 if form == "cost_affine" else 4) * N_el
            out.update(bound((reads + writes) * 4, flops))
            out["library_note"] = "no single PyTorch call computes this penalty"
            res[f"limit_penalty {cell} {form}"] = out
            emit(out)
            if not (out["binding_share_f64"] > 0 and out["binding_share_f32"] > 0):
                fail(f"limit_penalty {cell} {form}: the limits bind nowhere")
            if not (out["held_f64"] and out["held_f32"]):
                fail(f"limit_penalty {cell} {form}: kernel vs twin "
                     + ("beyond the sum-order bound" if is_cost
                        else "not bit for bit"))
    return res


def _gate_limit_launches(path, counts, sweeps):
    """Every limit evaluation of a fleet solve with limits is one launch of
    the limit-penalty kernel: the cost once for the initial rollout and
    once a line-search trial, the arrays once a backward sweep."""
    if (counts["limit_penalty_cost"] != 1 + counts["trials"]
            or counts["limit_penalty_arrays"] != sweeps):
        fail(f"{path}: limit_penalty launched {counts['limit_penalty_cost']} "
             f"cost and {counts['limit_penalty_arrays']} arrays times for "
             f"{counts['trials']} trials and {sweeps} sweeps")


def phase_riccati_rounding(torch):
    """One line a case, no gate: the riccati kernel against its twin on the
    card at inputs harder than the gated checks' (the limit penalty live on
    5% and on 20% of the entries, precisions at two steps, B = REC_B),
    float64 and float32, beside what the recursion itself does to rounding
    on the same inputs: the twin against the LU recursion in float64, and
    the float32 twin against the float64 twin. None marks a side that is
    not finite."""
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric

    Rt = [1e-5] * N
    prec_np = riccati_prec(False)
    for limit_frac in (0.05, 0.2):
        args_np = riccati_inputs(REC_B, limit_frac) + (prec_np,)
        out = {"phase": "riccati_rounding", "limit_frac": limit_frac,
               "batch": REC_B, "prec_steps": 2}
        twins = {}
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in args_np]
            K, d = ric.riccati_backward(*args, Rt, 0.1)
            Kt, dt_ = twins[tag] = ric.riccati_backward_reference(*args, Rt, 0.1)
            out[f"kernel_vs_twin_rel_K_{tag}"] = rel_diff(K, Kt)
            out[f"kernel_vs_twin_rel_d_{tag}"] = rel_diff(d, dt_)
            if tag == "f64":
                K_lu, asym = riccati_lu_sweep(torch, args[0], args[2], args[5])
                out["twin_vs_lu_rel_K_f64"] = rel_diff(Kt, K_lu)
                out["max_asym_P_f64"] = asym if math.isfinite(asym) else None
        out["twin_f32_vs_twin_f64_rel_K"] = rel_diff(twins["f32"][0].double(),
                                                     twins["f64"][0])
        emit(out)
        del twins, args, K, d, K_lu
        torch.cuda.empty_cache()


KERNELS = ("segment_backward", "segment_backward_2nd",
           "segment_backward_time1", "rollout_time1", "riccati")
# the __global__ function behind each, as the profiler names it
KERNEL_FUNCTIONS = {"segment_backward_kernel": "segment_backward",
                    "second_kernel": "segment_backward_2nd",
                    "time1_kernel": "segment_backward_time1",
                    "rollout_kernel": "rollout_time1",
                    "riccati_kernel": "riccati",
                    "limit_penalty_cost_kernel": "limit_penalty_cost",
                    "limit_penalty_arrays_kernel": "limit_penalty_arrays"}


def _reset_counts():
    from ilqr_planner_torch.ops.cuda_kernels import limit_penalty as lp
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
    from ilqr_planner_torch.solvers import fleet, ilqr

    sb.LAUNCHES = 0
    rt1.LAUNCHES = 0
    ric.LAUNCHES = 0
    for launches in (sb2.LAUNCHES, lp.LAUNCHES):
        for k in launches:
            launches[k] = 0
    fleet.TRIALS = 0
    fleet.GENERIC_SWEEPS = 0
    ilqr.TRIALS = 0


def _read_counts():
    from ilqr_planner_torch.ops.cuda_kernels import limit_penalty as lp
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.ops.cuda_kernels import rollout_time1 as rt1
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward_2nd as sb2
    from ilqr_planner_torch.solvers import fleet, ilqr

    return {"segment_backward": sb.LAUNCHES,
            "segment_backward_2nd": sb2.LAUNCHES["second"],
            "segment_backward_time1": sb2.LAUNCHES["time1"],
            "rollout_time1": rt1.LAUNCHES, "riccati": ric.LAUNCHES,
            "limit_penalty_cost": lp.LAUNCHES["cost"],
            "limit_penalty_arrays": lp.LAUNCHES["arrays"],
            "trials": fleet.TRIALS, "recursive_trials": ilqr.TRIALS,
            "generic_sweeps": fleet.GENERIC_SWEEPS}


def _drive(torch, spec, x0s, U0s, nb_iter, prefer_fleet=True, extra_ov=None,
           record=False, repeats=None, meter=None):
    """One solve with every count at 0 just before it, then `repeats`
    (default REPEATS) timed ones -> (result, counts, first_s, repeat times, the solve as a callable
    of the number of iterations). `extra_ov`: per-scenario keypoint
    overrides beside the initial state; `meter`: a CompileMeter around the
    first solve."""
    from ilqr_planner_torch.parallel import solve_batch

    x0s_t = torch.as_tensor(x0s, dtype=torch.float32, device="cuda")
    U0s_t = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    ov = {"q0": x0s_t[:, :spec.dof], "x0": x0s_t, **(extra_ov or {})}

    def run(n=nb_iter):
        return solve_batch(spec, ov, U0s_t, n, prefer_fleet=prefer_fleet,
                           record=record)

    return _timed_runs(torch, run, repeats, meter) + (run,)


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
    from ilqr_planner_torch.utils.compilemeter import CompileMeter

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = flagship_batch(B)
    meter = CompileMeter()
    res, counts, first_s, times, run = _drive(torch, spec, q0s, U0s, NB_ITER,
                                              meter=meter)
    split = meter.report(wall_s=first_s)
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
           "backward_sweeps": sweeps, "first_call_split": split}
    emit(out)
    if not out["shapes_ok"] or not out["finite"]:
        fail("flagship: result has the wrong shape or non-finite values")
    # phase 1 built every library: the first solve compiles nothing, and
    # builds its solver (the memo misses)
    if (split["compiles"] != 0 or split["solver_builds"] < 1
            or split["other_s"] < 0):
        fail(f"flagship: first-call split {split}: needs no nvcc run, at "
             f"least one solver build and other_s >= 0")
    if not math.isfinite(out["median_cost"]):
        fail("flagship: median cost is not finite")
    if out["converged_frac"] < 0.95:
        fail(f"flagship: converged fraction {out['converged_frac']} < 0.95")
    if counts["segment_backward"] == 0 or counts["segment_backward"] != sweeps:
        fail(f"flagship: segment_backward launched {counts['segment_backward']} "
             f"times for {sweeps} sweeps")
    _gate_limit_launches("flagship", counts, sweeps)
    others = [k for k in KERNELS if counts[k] and k != "segment_backward"]
    if others:
        fail(f"flagship: kernels of other paths launched: {others}")
    return out, run


def phase_recursive(torch):
    """The flagship's problem through solve_batch(prefer_fleet=False)."""
    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = recursive_batch(REC_B)
    res, counts, first_s, times, run = _drive(torch, spec, q0s, U0s, NB_ITER,
                                              prefer_fleet=False)
    sweeps = int(res.iterations.max())      # one backward sweep an iteration
    out = {"phase": "end_to_end", "path": "recursive", "nb_iter": NB_ITER,
           **_result_summary(res, REC_B, first_s, times, counts,
                             ((REC_B, H, N), (REC_B, H - 1, N), (REC_B, H, 7))),
           "converged_frac": float(np.mean(res.cost.double().cpu().numpy() < 1e-4)),
           "backward_sweeps": sweeps,
           "line_search_trials": counts["recursive_trials"]}
    emit(out)
    if not out["shapes_ok"] or not out["finite"] or not out["finite_costs"]:
        fail("recursive: result has the wrong shape or non-finite values")
    if out["converged_frac"] < 0.95:
        fail(f"recursive: converged fraction {out['converged_frac']} < 0.95")
    if sweeps == 0 or counts["riccati"] != sweeps:
        fail(f"recursive: riccati launched {counts['riccati']} times for "
             f"{sweeps} sweeps")
    if counts["recursive_trials"] < sweeps:
        fail(f"recursive: {counts['recursive_trials']} line-search trials for "
             f"{sweeps} iterations")
    others = [k for k in KERNELS if counts[k] and k != "riccati"]
    if others or counts["trials"]:
        fail(f"recursive: the fleet path ran (kernels {others}, "
             f"{counts['trials']} fleet trials)")
    return out, run


def _config(path):
    """(spec builder, batch builder, batch size, iterations) of a path."""
    if path == "flagship":
        return flagship_spec, flagship_batch, B, NB_ITER
    if path == "recursive":
        return flagship_spec, recursive_batch, REC_B, NB_ITER
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
    _gate_limit_launches(path, counts, sweeps)
    # the time-optimal rollout: once per line-search trial, and once for the
    # solve's initial rollout
    if path == "timeopt" and (counts["trials"] == 0 or
                              counts["rollout_time1"] != counts["trials"] + 1):
        fail(f"timeopt: rollout_time1 launched {counts['rollout_time1']} times "
             f"for {counts['trials']} trials and 1 initial rollout")
    others = [k for k in KERNELS
              if counts[k] and k != kern and not (path == "timeopt"
                                                  and k == "rollout_time1")]
    if others:
        fail(f"{path}: kernels of other paths launched: {others}")
    return out, run


def _solver(path, spec, nb_iter):
    """The path's solve as f(x0s, U0s): the fleet solver, or for the
    recursive path solve_batch(prefer_fleet=False)."""
    from ilqr_planner_torch.parallel import solve_batch
    from ilqr_planner_torch.solvers.fleet import make_fleet_solver

    if path == "recursive":
        return lambda x0s, U0s: solve_batch(spec, {"x0": x0s}, U0s, nb_iter,
                                            prefer_fleet=False)
    return make_fleet_solver(spec, nb_iter)


def _cpu_spread(solve, spec_cpu, x0s, U0s, c_cpu=None):
    """Each lane's own CPU spread: the same solve of the whole batch (a lane
    solved apart rounds otherwise) from x0 (its joint positions) moved by
    1e-15 relative up and down, the larger relative move of its cost from
    c_cpu (the unmoved solve's, solved here when None)."""
    if c_cpu is None:
        c_cpu = solve(spec_cpu, x0s, U0s).cost.numpy()
    spread = np.zeros(len(c_cpu))
    for sign in (1.0, -1.0):
        x0p = x0s.copy()
        x0p[:, :7] *= 1.0 + sign * XCHECK_PERTURB
        moved = solve(spec_cpu, x0p, U0s).cost.numpy()
        spread = np.maximum(spread, np.abs(moved - c_cpu) / np.abs(c_cpu))
    return spread


def _card_vs_cpu(torch, path, solve, spec_fn, x0s, U0s, kernels, sensitive,
                 rel=XCHECK_REL, u_rel=None, nan_ok=False, **info):
    """64 lanes of a problem in float64, `solve(spec, x0s, U0s)` on the card
    (the path's kernels) and on the CPU (their twins): the same iterations
    and alpha (where the result has one: AL results do not) on every lane,
    and every lane's cost within `rel` (1e-8) relative;
    where the solve is `sensitive`, a lane over 1e-8 whose CPU cost moves by
    more than 1e-9 relative when x0 moves by 1e-15 relative (up or down) is
    held to 10 times that move instead. The card must launch each of `kernels`, the CPU none.
    With `u_rel`, the controls (U, or the batch solver's flattened u) also
    within u_rel of the CPU's largest |U|. With `nan_ok`, lanes whose CPU
    cost is NaN must be NaN on the card and are left out of the rest.
    -> (the card's result, the card's spec)"""
    res, counts, specs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        specs[dev] = spec_fn(torch, torch.float64, dev)
        _reset_counts()
        res[dev] = solve(specs[dev], x0s, U0s)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts[dev] = _read_counts()
    gpu, cpu = res["cuda"], res["cpu"]
    c_gpu, c_cpu = gpu.cost.cpu().numpy(), cpu.cost.numpy()
    nan = np.isnan(c_cpu)
    if nan_ok:
        info["nan_lanes"] = np.flatnonzero(nan).tolist()
        info["same_nan_lanes"] = bool(np.array_equal(np.isnan(c_gpu), nan))
        if not info["same_nan_lanes"]:
            fail(f"{path}: the card's NaN lanes are not the CPU's")
        c_gpu, c_cpu = np.where(nan, 1.0, c_gpu), np.where(nan, 1.0, c_cpu)
    tol_rel = rel
    rel = np.abs(c_gpu - c_cpu) / np.abs(c_cpu)
    tol = np.full(rel.shape, tol_rel)
    alpha = getattr(gpu, "alpha", None)
    out = {"phase": "card_vs_cpu", "path": path, **info, "batch": len(c_cpu),
           "dtype": "float64",
           "same_iterations": bool(np.array_equal(gpu.iterations.cpu().numpy(),
                                                  cpu.iterations.numpy())),
           "same_alpha": alpha is None or bool(np.array_equal(
               alpha.cpu().numpy(), cpu.alpha.numpy())),
           "cost_max_rel_diff": float(rel.max()),
           "cost_median_rel_diff": float(np.median(rel)),
           "tolerance": tol_rel}
    over = np.flatnonzero(rel > tol_rel)
    if sensitive and over.size:
        spread = np.nan_to_num(_cpu_spread(solve, specs["cpu"], x0s, U0s,
                                           c_cpu))
        tol[over] = np.maximum(tol_rel, XCHECK_SENS_FACTOR * spread[over])
        out["lanes_over_1e-8"] = [
            {"lane": int(i), "rel_diff": float(rel[i]),
             "cpu_spread": float(spread[i]), "tolerance": float(tol[i])}
            for i in over]
    out.update({
        "lanes_over_tolerance": [int(i) for i in np.flatnonzero(rel > tol)],
        "median_cost": float(np.median(c_cpu)),
        "median_iterations": float(np.median(cpu.iterations.numpy())),
        "card_kernel_launches": {k: counts["cuda"][k] for k in KERNELS},
        "cpu_kernel_launches": {k: counts["cpu"][k] for k in KERNELS},
        "U_max_abs_diff": float((_controls(gpu).cpu() - _controls(cpu))[
            ~torch.as_tensor(nan)].abs().max()),
        "U_max_abs": float(_controls(cpu)[~torch.as_tensor(nan)].abs().max())})
    emit(out)
    if not (np.isfinite(c_gpu).all() and np.isfinite(c_cpu).all()):
        fail(f"{path}: non-finite costs")
    if not (out["same_iterations"] and out["same_alpha"]
            and not out["lanes_over_tolerance"]):
        fail(f"{path}: card and CPU disagree")
    if u_rel is not None and out["U_max_abs_diff"] > u_rel * out["U_max_abs"]:
        fail(f"{path}: the card's controls differ from the CPU's by "
             f"{out['U_max_abs_diff']} (> {u_rel} of max |U| {out['U_max_abs']})")
    if (any(counts["cuda"][k] == 0 for k in kernels)
            or any(out["cpu_kernel_launches"].values())):
        fail(f"{path}: the card run must launch {list(kernels)} and the CPU "
             f"run must not launch a kernel")
    return gpu, specs["cuda"]


def _controls(res):
    """A result's controls: U of the iLQR results, u of the batch solver's."""
    return res.U if hasattr(res, "U") else res.u


# each path's kernels, which its card run must launch
PATH_KERNELS = {"flagship": ("segment_backward",), "recursive": ("riccati",),
                "posorn2nd": ("segment_backward_2nd",),
                "timeopt": ("segment_backward_time1", "rollout_time1")}


def phase_cross_check(torch, path):
    """The path's first 64 lanes on the card and on the CPU (its solves are
    sensitive: the timeopt path's and some lanes of the others'); for the
    recursive path also against the fleet path on the card."""
    spec_fn, batch_fn, batch, nb_iter = _config(path)
    x0s, U0s = batch_fn(batch)
    gpu, spec_gpu = _card_vs_cpu(
        torch, path, lambda spec, x, u: _solver(path, spec, nb_iter)(x, u), spec_fn,
        x0s[:XCHECK_B], U0s[:XCHECK_B], PATH_KERNELS[path], True)
    if path != "recursive":
        return
    fleet = _solver("flagship", spec_gpu, nb_iter)(x0s[:XCHECK_B], U0s[:XCHECK_B])
    c_gpu, c_fleet = gpu.cost.cpu().numpy(), fleet.cost.cpu().numpy()
    rel = float(np.max(np.abs(c_gpu - c_fleet) / np.abs(c_fleet)))
    out = {"phase": "recursive_vs_fleet", "batch": XCHECK_B, "dtype": "float64",
           "same_iterations": bool(torch.equal(gpu.iterations, fleet.iterations)),
           "same_alpha": bool(torch.equal(gpu.alpha, fleet.alpha)),
           "cost_max_rel_diff": rel, "tolerance": XCHECK_REL,
           "U_max_abs_diff": float((gpu.U - fleet.U).abs().max()),
           "Ks_max_abs_diff": float((gpu.Ks - fleet.Ks).abs().max())}
    emit(out)
    if rel > XCHECK_REL:
        fail("recursive and fleet paths disagree on the card")


def joint_spec(torch, dtype, device):
    """Joint-angle targets (the joint kind: a 7-wide residual) at steps 49
    and 99 from the flagship's start, its horizon, dt and limits."""
    from ilqr_planner_torch.systems.keypoints import AngularKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    kps = [AngularKeypoint(Q0 - 0.2, np.eye(7), H // 2 - 1),
           AngularKeypoint(Q0 + 0.3, np.eye(7), H - 1)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("joint", _panda(dtype, device), kps, np.ones(7) * 1e-5,
                     H, 1, dt=0.1, q0=Q0, q_max=qmax, q_min=-qmax, dtype=dtype,
                     device=device)


def _solve_batch(prefer_fleet):
    from ilqr_planner_torch.parallel import solve_batch

    return lambda spec, x0s, U0s: solve_batch(spec, {"x0": x0s}, U0s, NB_ITER,
                                              prefer_fleet=prefer_fleet)


def phase_joint_cross_check(torch):
    """64 lanes of the joint-target problem through the recursive solver
    (the riccati kernel at nq = 7), every lane within 1e-8."""
    q0s, U0s = recursive_batch(XCHECK_B)
    _card_vs_cpu(torch, "joint_recursive", _solve_batch(False), joint_spec, q0s,
                 U0s, ("riccati",), False, nq=7)


def phase_chain6_cross_check(torch):
    """64 lanes of the flagship's problem on the 6-DoF chain through the
    fleet (segment_backward at n = 6, built at first use), under the paths'
    gate."""
    q0s, U0s = flagship_batch(XCHECK_B)
    _card_vs_cpu(torch, "flagship_6dof", _solve_batch(True),
                 lambda *a: flagship_spec(*a, dof=6), q0s[:, :6], U0s[..., :6],
                 ("segment_backward",), True, dof=6)


def phase_dense_vs_sparse(torch):
    """One line, no gate: the two backward passes of the flagship problem at
    B = REC_B on random states, float32 -- the dense input assembly (forward
    kinematics, Jacobian, residual and limit terms at every step) and the
    riccati kernel, beside the fleet's backward (keypoint-sparse assembly +
    segment_backward) and segment_backward alone."""
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
    from ilqr_planner_torch.solvers import fleet
    from ilqr_planner_torch.systems import funcs

    spec = flagship_spec(torch, torch.float32, "cuda")
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(H, N, REC_B)) * 0.3 + Q0[None, :, None],
                        dtype=torch.float32, device="cuda")
    U = torch.as_tensor(rng.normal(size=(H - 1, N, REC_B)) * 0.1,
                        dtype=torch.float32, device="cuda")
    Xb, Ub = X.permute(2, 0, 1).contiguous(), U.permute(2, 0, 1).contiguous()
    ks = torch.arange(H, device="cuda")
    Rt, dt = spec.Rt.tolist(), float(spec.dt)

    def assemble():
        fX, Js = funcs.fx_jac(spec, Xb)
        ld, lq = funcs.limit_terms(spec, Xb)
        return (Js.contiguous(), funcs.residual(spec, fX, ks).contiguous(), ld,
                lq, Ub, spec.prec)

    ins = assemble()
    cc = fleet._Consts(spec)
    sweep_args = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                  for a in sweep_inputs(N, N, H - 1, len(KP_INNER), REC_B)]
    Kr, dr = ric.riccati_backward(*ins, Rt, dt)
    Kf, df = fleet._backward(cc, X, U)
    emit({"phase": "dense_vs_sparse_backward", "batch": REC_B, "dtype": "float32",
          "dense_assembly_ms": cuda_ms(torch, assemble),
          "riccati_ms": cuda_ms(torch, lambda: ric.riccati_backward(*ins, Rt, dt)),
          "fleet_backward_with_sparse_assembly_ms": cuda_ms(
              torch, lambda: fleet._backward(cc, X, U)),
          "segment_backward_ms": cuda_ms(
              torch, lambda: sb.segment_backward(*sweep_args, KP_INNER, 0.1,
                                                 [1e-5] * N)),
          "agreement_max_abs_dK": float(
              (Kr - Kf.permute(3, 0, 1, 2)).abs().max()),
          "agreement_max_abs_dd": float((dr - df.permute(2, 0, 1)).abs().max())})


# The profiled window: the solve's initial rollout and its first two
# iterations. Early iterations accept alpha = 1 on most paths (one trial
# each), while a whole solve backtracks later (the recursive path: 63 trials
# in 10 iterations), so the window's line of `line_search_trials` says how
# many trial rollouts its shares stand for.
PROFILE_ITERS = 2


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total


def _profiled(torch, path, fn):
    """fn() once to warm up, once timed unprofiled with every count at 0
    just before it, once under torch.profiler -> (the CUDA kernel events,
    the unprofiled wall s, the counts of the timed run); the table goes to
    chiprun_out/profile_<path>.txt."""
    fn()                                    # builds the solver's constants
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts = _read_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=60)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_{path}.txt"), "w") as f:
        f.write(table)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, wall_s, counts


def profile_window(torch, path, run):
    """Device time by kernel over a window of the path's solve,
    `run(PROFILE_ITERS)`: the initial rollout, then per iteration one
    backward sweep and its line search. The window is timed once unprofiled
    first, so busy / wall is the device's busy share. (Tracing a whole
    solve of 46k-197k launches cost the profiler a minute a path and shows
    the same kernels.)"""
    kernels, wall_s, counts = _profiled(torch, path,
                                        lambda: run(PROFILE_ITERS))
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -_dev_us(e))[:8]
    ours = {}   # every instantiation of a kernel together
    for e in kernels:
        for name in KERNEL_FUNCTIONS:
            if f"::{name}<" in e.key:
                us, count = ours.get(name, (0.0, 0))
                ours[name] = (us + _dev_us(e), count + e.count)
    ours = {name: [us / 1e3 / count, count] for name, (us, count) in ours.items()}
    emit({"phase": "profile", "path": path, "iterations": PROFILE_ITERS,
          "hand_written_kernels_ms_a_launch": ours,
          "line_search_trials": counts["trials"] + counts["recursive_trials"],
          "unprofiled_wall_ms": 1e3 * wall_s, "device_busy_ms": busy_ms,
          "device_launches": sum(e.count for e in kernels),
          "busy_share_of_unprofiled_wall": busy_ms / 1e3 / wall_s,
          "top_kernels": [[e.key[:80], _dev_us(e) / 1e3, e.count] for e in top]})
    return ours


# ---------------------------------------------------------------------------
# this slice's configurations: per-scenario keypoint overrides with record,
# two object frames (a sequential spec), the planar arm, and the hybrid
# joint + position/orientation spec
# ---------------------------------------------------------------------------

# The JAX package's own float32 median costs on its TPU (BENCH_TABLE.json
# rows sequential_2frames_h600_ilqr10 and planar2d_h100_ilqr10): quality
# targets, never speeds.
SEQ_H, SEQ_B, SEQ_JAX_COST = 600, 1024, 1.341e-06
PLANAR_B, PLANAR_JAX_COST = 4096, 2.705e-4
HYBRID_H, HYBRID_B, HYBRID_JAX_COST = 500, 8192, 2.437e-4
# timed repeats of each recursive-route run of the sequential, hybrid and
# planar problems and of al_h400 (a solve there takes seconds: the
# recursion is host-bound over H steps)
RECURSIVE_SLICE_REPEATS = 2
# the two object frames of the reference's multi-frame tutorial
OBJ_QUATS = ([0.63758403393523, 0.2994657314658187, 0.6042309402208079,
              -0.37244039285286973],
             [-0.03647984, 0.94060485, 0.33742794, 0.00860923])
OBJ_POS = ([0.62, 0.05, 0.34], [0.32, 0.05, 0.54])
PLANAR_LENGTHS = [1.0, 0.8, 0.5]
PLANAR_Q0 = np.array([0.5, -0.2, 0.8])
OV_SEED = 10


def flagship_ov_arrays(batch):
    """The per-lane draws of the overridden flagship, seed 10: the target
    positions at steps 49 and 99 moved by N(0, 0.02 m) per axis, the
    step-99 precision scaled by U(1, 1.5), a dead-zone radius U(0, 0.01) m
    at step 49."""
    rng = np.random.default_rng(OV_SEED)
    return (rng.normal(scale=0.02, size=(batch, 2, 3)),
            rng.uniform(1.0, 1.5, size=batch), rng.uniform(0.0, 0.01, size=batch))


def flagship_overrides(torch, spec, batch, names=("mu", "prec", "pos_radius",
                                                  "orn_thresh")):
    """The overrides of `flagship_ov_arrays` as [B, ...] tensors on the
    spec's device and in its dtype (orn_thresh all zeros), built there: the
    float32 precisions of 36864 lanes are 531 MB."""
    shift, scale, radius = flagship_ov_arrays(batch)
    dev, dt = spec.device, spec.dtype
    out = {}
    if "mu" in names:
        mu = spec.mu[None].repeat(batch, 1, 1)
        mu[:, [49, 99], :3] += torch.as_tensor(shift, dtype=dt, device=dev)
        out["mu"] = mu
    if "prec" in names:
        prec = spec.prec[None].repeat(batch, 1, 1, 1)
        prec[:, 99] *= torch.as_tensor(scale, dtype=dt, device=dev)[:, None, None]
        out["prec"] = prec
    if "pos_radius" in names:
        rad = torch.zeros((batch, H), dtype=dt, device=dev)
        rad[:, 49] = torch.as_tensor(radius, dtype=dt, device=dev)
        out["pos_radius"] = rad
    if "orn_thresh" in names:
        out["orn_thresh"] = torch.zeros((batch, H, 3), dtype=dt, device=dev)
    return out


def _frames():
    out = []
    for quat, pos in zip(OBJ_QUATS, OBJ_POS):
        w, x, y, z = quat
        T = np.eye(4)
        T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
        T[:3, 3] = pos
        out.append(T)
    return out


def sequential_spec_h600(torch, dtype, device):
    """bench_table.py sequential_2frames_h600_ilqr10: two object frames,
    keypoints at 300 (frame 1) and 599 (frame 2), H=600, dt=0.01."""
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec, sequential_spec

    robot = _panda(dtype, device)
    obj1, obj2 = _frames()
    qmax = np.ones(7) * np.pi * 10
    qd = np.diag([1, 1, 1, 0, 0, 0])
    cmd = np.ones(7) * 1e-5
    kw = dict(dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax, dtype=dtype, device=device)
    sub1 = make_spec("posorn", robot.with_frame(obj1),
                     [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], qd, SEQ_H // 2)],
                     cmd, SEQ_H, 1, **kw)
    sub2 = make_spec("posorn", robot.with_frame(obj2),
                     [PosOrnKeypoint([0.1, 0.1, -0.1], [1, 0, 0, 0], qd, SEQ_H - 1)],
                     cmd, SEQ_H, 1, **kw)
    return sequential_spec((sub1, sub2), cmd, dtype=dtype)


def sequential_batch(batch):
    """bench_table.py's _q0s(B, sigma=0.02): q0 + 0.02 N(0, 1), seed 0."""
    rng = np.random.default_rng(0)
    q0s = Q0[None] + 0.02 * rng.normal(size=(batch, 7))
    return q0s, np.zeros((batch, SEQ_H - 1, 7))


def planar_spec(torch, dtype, device):
    """bench_table.py planar2d_h100_ilqr10: a 3-link planar arm (lengths 1,
    0.8, 0.5), position targets at 49 and 99, H=100, dt=0.1."""
    from ilqr_planner_torch.models import PlanarRobot, Robot
    from ilqr_planner_torch.systems.keypoints import PointKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    robot = Robot.from_planar(PlanarRobot(torch.as_tensor(
        PLANAR_LENGTHS, dtype=dtype, device=device)))
    kps = [PointKeypoint([1.2, 0.9], np.eye(2), 49),
           PointKeypoint([0.5, 1.6], np.eye(2), 99)]
    return make_spec("point", robot, kps, np.ones(3) * 1e-5, H, 1, dt=0.1,
                     q0=PLANAR_Q0, dtype=dtype, device=device)


def planar_batch(batch):
    """q0 + 0.05 N(0, 1), seed 2 (bench_table.py)."""
    rng = np.random.default_rng(2)
    q0s = PLANAR_Q0[None] + 0.05 * rng.normal(size=(batch, 3))
    return q0s, np.zeros((batch, H - 1, 3))


def hybrid_spec(torch, dtype, device):
    """bench_table.py hybrid_h500_ilqr10: a joint target at 250 and a
    position/orientation target at 499, H=500, dt=0.01."""
    from ilqr_planner_torch.systems.keypoints import AngularKeypoint, PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec, sequential_spec

    robot = _panda(dtype, device)
    qmax = np.ones(7) * np.pi * 10
    cmd = np.ones(7) * 1e-5
    kw = dict(dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax, dtype=dtype, device=device)
    sj = make_spec("joint", robot, [AngularKeypoint(Q0 + 0.2, np.eye(7) * 0.1,
                                                    HYBRID_H // 2)],
                   cmd, HYBRID_H, 1, **kw)
    st = make_spec("posorn", robot, [PosOrnKeypoint(*T2, np.diag(QD6),
                                                    HYBRID_H - 1)],
                   cmd, HYBRID_H, 1, **kw)
    return sequential_spec((sj, st), cmd, dtype=dtype)


def hybrid_batch(batch):
    """bench_table.py's _q0s(B, sigma=0.02, seed=5)."""
    rng = np.random.default_rng(5)
    q0s = Q0[None] + 0.02 * rng.normal(size=(batch, 7))
    return q0s, np.zeros((batch, HYBRID_H - 1, 7))


def _gate_quality(out, name, jax_cost):
    out["jax_tpu_median_cost"] = jax_cost
    out["median_cost_over_jax"] = out["median_cost"] / jax_cost
    emit(out)
    if not out["shapes_ok"] or not out["finite"] or not out["finite_costs"]:
        fail(f"{name}: result has the wrong shape or non-finite values")
    if not 1 / COST_RATIO_GATE <= out["median_cost_over_jax"] <= COST_RATIO_GATE:
        fail(f"{name}: median cost {out['median_cost']} not within "
             f"{COST_RATIO_GATE}x of the JAX record {jax_cost}")


def _gate_only(name, counts, sweeps, kernel="segment_backward"):
    if sweeps == 0 or counts[kernel] != sweeps:
        fail(f"{name}: {kernel} launched {counts[kernel]} times for {sweeps} "
             f"sweeps")
    others = [k for k in KERNELS if counts[k] and k != kernel]
    if others:
        fail(f"{name}: kernels of other paths launched: {others}")


def phase_flagship_ov(torch):
    """The flagship with per-lane targets, precisions, dead zones and
    thresholds, record=True, at full width; the host time of binding the
    overrides to lanes; the record gate."""
    from ilqr_planner_torch.solvers import fleet

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = flagship_batch(B)
    t0 = time.time()
    ov = flagship_overrides(torch, spec, B)
    torch.cuda.synchronize()
    make_s = time.time() - t0
    res, counts, first_s, times, run = _drive(torch, spec, q0s, U0s, NB_ITER,
                                              extra_ov=ov, record=True)
    cc = fleet._Consts(spec, tuple(sorted(ov)))
    bind_s = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        fleet._bind_ov(cc, ov)
        torch.cuda.synchronize()
        bind_s.append(time.time() - t0)
    sweeps = int(res.iterations.max())
    cost = res.cost.double().cpu().numpy()
    it = res.iterations.long()
    pc = res.progress["cost"]
    lanes = torch.arange(B, device="cuda")
    cols = torch.arange(NB_ITER, device="cuda")[None]
    record_ok = (bool(torch.equal(pc[lanes, it - 1], res.cost))
                 and bool(torch.equal(torch.isnan(pc), cols >= it[:, None]))
                 and bool(torch.equal(torch.isnan(res.progress["alpha"]),
                                      cols >= it[:, None])))
    out = {"phase": "end_to_end", "path": "flagship_ov", "nb_iter": NB_ITER,
           "overrides": sorted(ov), "record": True,
           **_result_summary(res, B, first_s, times, counts,
                             ((B, H, N), (B, H - 1, N), (B, H, 7))),
           "converged_frac": float(np.mean(cost < 1e-4)),
           "backward_sweeps": sweeps,
           "make_overrides_s": make_s,
           "bind_overrides_ms_median": 1e3 * statistics.median(bind_s),
           "record_gate": record_ok}
    emit(out)
    if not out["shapes_ok"] or not out["finite"] or not out["finite_costs"]:
        fail("flagship_ov: result has the wrong shape or non-finite values")
    if out["converged_frac"] < 0.95:
        fail(f"flagship_ov: converged fraction {out['converged_frac']} < 0.95")
    if not record_ok:
        fail("flagship_ov: the record does not end at each lane's final cost "
             "with NaN beyond its last iteration")
    _gate_only("flagship_ov", counts, sweeps)
    return out, run, ov


def phase_staged(torch, ov):
    """solve_batch_staged on the overridden flagship's lanes (first stage 8
    of 10 iterations: the lanes that used 8 are solved again, in a smaller
    batch) against plain solve_batch: the same iterations, alpha, cost and
    U on every lane, bit for bit."""
    from ilqr_planner_torch.parallel import solve_batch, solve_batch_staged

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = flagship_batch(B)
    x0 = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    U0 = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    full = {"x0": x0, **ov}
    plain = solve_batch(spec, full, U0, NB_ITER)
    torch.cuda.synchronize()
    t0 = time.time()
    staged = solve_batch_staged(spec, full, U0, NB_ITER, first_stage=8)
    torch.cuda.synchronize()
    staged_s = time.time() - t0
    rel = float(((staged.cost - plain.cost).abs() / plain.cost.abs()).max())
    out = {"phase": "staged_vs_plain", "batch": B, "dtype": "float32",
           "first_stage": 8, "staged_s": staged_s,
           "lanes_restaged": int((plain.iterations >= 8).sum()),
           "same_iterations": bool(torch.equal(staged.iterations, plain.iterations)),
           "same_alpha": bool(torch.equal(staged.alpha, plain.alpha)),
           "bitwise_equal_cost": bool(torch.equal(staged.cost, plain.cost)),
           "bitwise_equal_U": bool(torch.equal(staged.U, plain.U)),
           "cost_max_rel_diff": rel}
    emit(out)
    if not all(out[k] for k in ("same_iterations", "same_alpha",
                                "bitwise_equal_cost", "bitwise_equal_U")):
        fail("staged and plain solve_batch disagree")


def phase_sequential(torch):
    spec = sequential_spec_h600(torch, torch.float32, "cuda")
    x0s, U0s = sequential_batch(SEQ_B)
    res, counts, first_s, times, run = _drive(torch, spec, x0s, U0s, NB_ITER)
    out = {"phase": "end_to_end", "path": "sequential_h600", "nb_iter": NB_ITER,
           **_result_summary(res, SEQ_B, first_s, times, counts,
                             ((SEQ_B, SEQ_H, N), (SEQ_B, SEQ_H - 1, N),
                              (SEQ_B, SEQ_H, 14))),
           "backward_sweeps": int(res.iterations.max())}
    _gate_quality(out, "sequential_h600", SEQ_JAX_COST)
    _gate_only("sequential_h600", counts, int(res.iterations.max()))
    return out, run


def phase_planar(torch):
    spec = planar_spec(torch, torch.float32, "cuda")
    x0s, U0s = planar_batch(PLANAR_B)
    res, counts, first_s, times, run = _drive(torch, spec, x0s, U0s, NB_ITER)
    out = {"phase": "end_to_end", "path": "planar2d", "nb_iter": NB_ITER,
           **_result_summary(res, PLANAR_B, first_s, times, counts,
                             ((PLANAR_B, H, 3), (PLANAR_B, H - 1, 3),
                              (PLANAR_B, H, 2))),
           "backward_sweeps": int(res.iterations.max())}
    _gate_quality(out, "planar2d", PLANAR_JAX_COST)
    _gate_only("planar2d", counts, int(res.iterations.max()))
    return out, run


def phase_recursive_slice(torch, path):
    """One of this slice's problems at full width through
    solve_batch(prefer_fleet=False), float32: the recursive solver, whose
    riccati kernel runs at the problem's residual width (sequential_h600
    (7, 12), hybrid_h500 (7, 13) at B = 8192 as in bench_table.py,
    planar2d (3, 2)). Counts at 0 just before the first solve; riccati
    once a backward sweep, no fleet kernel or trial; the median cost within
    2x of the JAX package's record."""
    spec_fn, batch_fn, batch, jax_cost = {
        "sequential_h600": (sequential_spec_h600, sequential_batch, SEQ_B,
                            SEQ_JAX_COST),
        "hybrid_h500": (hybrid_spec, hybrid_batch, HYBRID_B, HYBRID_JAX_COST),
        "planar2d": (planar_spec, planar_batch, PLANAR_B, PLANAR_JAX_COST)}[path]
    spec = spec_fn(torch, torch.float32, "cuda")
    x0s, U0s = batch_fn(batch)
    res, counts, first_s, times, run = _drive(
        torch, spec, x0s, U0s, NB_ITER, prefer_fleet=False,
        repeats=RECURSIVE_SLICE_REPEATS)
    h = spec.horizon
    sweeps = int(res.iterations.max())      # one backward sweep an iteration
    name = f"{path}_recursive"
    out = {"phase": "end_to_end", "path": name, "nb_iter": NB_ITER,
           "riccati_width": [spec.nu, spec.nq_var],
           **_result_summary(res, batch, first_s, times, counts,
                             ((batch, h, spec.nx), (batch, h - 1, spec.nu),
                              (batch, h, spec.nt))),
           "backward_sweeps": sweeps,
           "line_search_trials": counts["recursive_trials"]}
    _gate_quality(out, name, jax_cost)
    _gate_only(name, counts, sweeps, kernel="riccati")
    if counts["trials"] or counts["recursive_trials"] < sweeps:
        fail(f"{name}: {counts['trials']} fleet trials and "
             f"{counts['recursive_trials']} recursive trials for {sweeps} "
             f"iterations")
    return out, run


def _seq_list_overrides(torch, spec, batch):
    """A per-subsystem list override [mu_b, None]: the first frame's target
    moved by N(0, 0.02 m) per axis a lane (seed 11), the second kept."""
    rng = np.random.default_rng(11)
    mu = spec.subs[0].mu[None].repeat(batch, 1, 1)
    mu[:, SEQ_H // 2, :3] += torch.as_tensor(rng.normal(scale=0.02, size=(batch, 3)),
                                             dtype=spec.dtype, device=spec.device)
    return {"mu": [mu, None]}


def _routes_agree(torch, label, gpu, solve_of, spec_fn, x0s, U0s, **info):
    """The fleet and recursive routes' card results `gpu` {"fleet",
    "recursive"} of one problem: the same iterations (and alpha, where the
    result has one) and every lane's cost within 1e-8 relative, or, for a
    lane over it, within 10 times the larger of the two routes' CPU spreads
    (`_cpu_spread` of `solve_of(prefer_fleet)`): each route rounds otherwise
    at every iteration (`tools/route_gap.py` tests this rule's premise on
    the CPU)."""
    f, r = gpu["fleet"], gpu["recursive"]
    rel = ((r.cost - f.cost).abs() / f.cost.abs()).cpu().numpy()
    tol = np.full(rel.shape, XCHECK_REL)
    over = np.flatnonzero(rel > XCHECK_REL)
    alpha = getattr(f, "alpha", None)
    out = {"phase": "recursive_vs_fleet", "config": label, **info,
           "batch": len(rel), "dtype": "float64",
           "same_iterations": bool(torch.equal(r.iterations, f.iterations)),
           "same_alpha": alpha is None or bool(torch.equal(r.alpha, alpha)),
           "cost_max_rel_diff": float(rel.max()), "tolerance": XCHECK_REL,
           "U_max_abs_diff": float((r.U - f.U).abs().max())}
    if over.size:
        spec_cpu = spec_fn(torch, torch.float64, "cpu")
        sf, sr = (_cpu_spread(solve_of(prefer), spec_cpu, x0s, U0s)
                  for prefer in (True, False))
        spread = np.maximum(sf, sr)
        tol[over] = np.maximum(XCHECK_REL, XCHECK_SENS_FACTOR * spread[over])
        out["lanes_over_1e-8"] = [
            {"lane": int(i), "rel_diff": float(rel[i]),
             "cpu_spread_fleet": float(sf[i]),
             "cpu_spread_recursive": float(sr[i]),
             "tolerance": float(tol[i])} for i in over]
    out["lanes_over_tolerance"] = [int(i) for i in np.flatnonzero(rel > tol)]
    emit(out)
    if out["lanes_over_tolerance"]:
        fail(f"{label}: the recursive and fleet routes disagree on the card")


def phase_slice_cross_checks(torch):
    """64 lanes of each of this slice's problems in float64, card against
    CPU (the paths' per-lane gate), on the fleet and on the recursive route;
    and the two routes against each other on the card (cost within 1e-8)."""
    from ilqr_planner_torch.parallel import solve_batch

    def solve(prefer, nb_iter, ov_fn=None):
        def f(spec, x0s, U0s):
            ov = {"x0": x0s, **(ov_fn(torch, spec, x0s.shape[0]) if ov_fn else {})}
            return solve_batch(spec, ov, U0s, nb_iter, prefer_fleet=prefer)
        return f

    def three(t, spec, batch):
        return flagship_overrides(t, spec, batch, ("mu", "pos_radius",
                                                   "orn_thresh"))

    fb = flagship_batch(XCHECK_B)
    cases = [
        # (label, spec, batch, overrides, fleet kernels, recursive kernels)
        ("flagship_ov", flagship_spec, fb, flagship_overrides,
         ("segment_backward",), ()),      # a per-lane prec: the generic sweep
        ("flagship_ov3", flagship_spec, fb, three, ("segment_backward",),
         ("riccati",)),
        ("sequential_h600", sequential_spec_h600, sequential_batch(XCHECK_B),
         None, ("segment_backward",), ("riccati",)),
        ("sequential_list_ov", sequential_spec_h600, sequential_batch(XCHECK_B),
         _seq_list_overrides, ("segment_backward",), ("riccati",)),
        ("planar2d", planar_spec, planar_batch(XCHECK_B), None,
         ("segment_backward",), ("riccati",)),
        ("hybrid_h500", hybrid_spec, hybrid_batch(XCHECK_B), None,
         ("segment_backward",), ("riccati",)),
    ]
    for label, spec_fn, (x0s, U0s), ov_fn, k_fleet, k_rec in cases:
        gpu = {}
        for prefer, kernels in ((True, k_fleet), (False, k_rec)):
            route = "fleet" if prefer else "recursive"
            gpu[route], _ = _card_vs_cpu(
                torch, f"{label}_{route}", solve(prefer, NB_ITER, ov_fn), spec_fn,
                x0s, U0s, kernels, True, route=route)
        _routes_agree(torch, label, gpu, lambda prefer: solve(prefer, NB_ITER, ov_fn),
                      spec_fn, x0s, U0s)


def phase_record_recursive(torch):
    """record=True on the recursive route (riccati; the overrides that keep
    it) and in ilqr.solve, float64, 64 lanes, card against CPU: the same
    iterations, NaN at the same entries of the record, alpha equal, every
    recorded cost within 1e-8 relative; each lane's record ends at its
    final cost, and so does the single solve's."""
    from ilqr_planner_torch.parallel import solve_batch
    from ilqr_planner_torch.solvers import ilqr

    x0s, U0s = flagship_batch(XCHECK_B)
    res, launches = {}, {}
    for dev in ("cuda", "cpu"):
        spec = flagship_spec(torch, torch.float64, dev)
        ov = {"x0": x0s, **flagship_overrides(torch, spec, XCHECK_B,
                                              ("mu", "pos_radius", "orn_thresh"))}
        _reset_counts()
        res[dev] = solve_batch(spec, ov, U0s, NB_ITER, prefer_fleet=False,
                               record=True)
        launches[dev] = _read_counts()["riccati"]
    one = ilqr.solve(flagship_spec(torch, torch.float64, "cuda"), U0s[0],
                     NB_ITER, record=True)
    gpu, cpu = res["cuda"], res["cpu"]
    pc_g, pc_c = gpu.progress["cost"].cpu(), cpu.progress["cost"]
    finite = ~torch.isnan(pc_c)
    rel = float(((pc_g - pc_c).abs() / pc_c.abs())[finite].max())
    it = gpu.iterations.long().cpu()
    out = {"phase": "record_recursive", "batch": XCHECK_B, "dtype": "float64",
           "same_iterations": bool(torch.equal(gpu.iterations.cpu(), cpu.iterations)),
           "same_nan": bool(torch.equal(torch.isnan(pc_g), ~finite)),
           "same_alpha": bool(torch.equal(  # NaN beyond each lane's last
               gpu.progress["alpha"].cpu().nan_to_num(-1.0),
               cpu.progress["alpha"].nan_to_num(-1.0))),
           "record_ends_at_cost": bool(torch.equal(
               pc_g[torch.arange(XCHECK_B), it - 1], gpu.cost.cpu())),
           "single_solve_record_ends_at_cost": bool(
               one.progress["cost"][int(one.iterations) - 1] == one.cost),
           "recorded_cost_max_rel_diff": rel, "tolerance": XCHECK_REL,
           "riccati_launches": launches}
    emit(out)
    if not all(out[k] for k in ("same_iterations", "same_nan", "same_alpha",
                                "record_ends_at_cost",
                                "single_solve_record_ends_at_cost")):
        fail("record on the recursive route: card and CPU disagree")
    if launches["cuda"] == 0 or launches["cpu"]:
        fail(f"record on the recursive route: riccati launches {launches}")
    if rel > XCHECK_REL:
        fail(f"record on the recursive route: recorded costs {rel} apart")


def phase_slice_kernels(torch):
    """The kernels at this slice's new shapes against their twins: riccati
    at the sequential specs' widths (7, 12) and (7, 13) and the planar
    (3, 2); segment_backward at H=600 with inner keypoints at 299 and at 0
    on a ragged batch, and at the planar arm's n = 3, H = 100, B = 4096.
    -> {label: the kernel-vs-twin line}"""
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb

    res = {}
    for n, nq, h, batch in ((7, 12, SEQ_H, SEQ_B + 37), (7, 13, HYBRID_H, HYBRID_B + 37),
                            (3, 2, H, PLANAR_B + 37)):
        Rt_n = [1e-5] * n
        prec = np.zeros((h, nq, nq))
        prec[[h // 2, h - 1]] = np.eye(nq)
        out = _kernel_vs_twin(
            torch, "riccati", {"n": n, "nq": nq, "H": h, "B": batch,
                               "prec_steps": (h // 2, h - 1)},
            riccati_inputs(batch, seed=8, nq=nq, h=h, n=n) + (prec,),
            lambda *a: ric.riccati_backward(*a, Rt_n, 0.01),
            lambda *a: ric.riccati_backward_reference(*a, Rt_n, 0.01), 2, inner=3)
        out.update(bound(riccati_bytes(n, nq, h, batch, 4),
                         riccati_flops(n, nq, h, batch)))
        out["launch"] = _launch_of(
            torch, "riccati", lambda dt_: ric.launch_geometry(batch, dt_, n, nq),
            lambda dt_: ric.kernel_geometry(batch, dt_, n, nq))
        res[f"riccati {n}x{nq}"] = _gate_kernel(out)
    for n, hm1, batch, kp, dt, tag in (
            (N, SEQ_H - 1, SEQ_B + 37, (0, 299), 0.01, "H600"),
            (3, H - 1, PLANAR_B, KP_INNER, 0.1, "n3")):
        out = _kernel_vs_twin(
            torch, "segment_backward", {"n": n, "H": hm1 + 1, "B": batch,
                                        "kp_inner": kp},
            sweep_inputs(n, n, hm1, len(kp), batch, seed=9),
            lambda *a: sb.segment_backward(*a, kp, dt, [1e-5] * n),
            lambda *a: sb.segment_backward_reference(*a, kp, dt, [1e-5] * n),
            2, inner=3)
        out.update(bound(sweep_bytes(n, hm1, len(kp), batch, 4),
                         sweep_flops(n, hm1, len(kp), batch)))
        out["launch"] = _launch_of(
            torch, "segment_backward", lambda dt_: sb.launch_geometry(batch, dt_, n),
            lambda dt_: sb.kernel_geometry(batch, dt_, n))
        res[f"segment_backward {tag}"] = _gate_kernel(out)
    return res


# ---------------------------------------------------------------------------
# this slice's configurations: AL-iLQR under the reference tutorial's state
# bound, and the time-optimal double integrator
# ---------------------------------------------------------------------------

# bench_table.py al_h400_100it: H=400, the bound x5 <= 2 in a 14-row A (13
# inert zero rows), 100 iterations through the staged schedule, B=8192;
# the JAX package's own float32 median cost on its TPU (BENCH_TABLE.json):
# a quality target, never a speed
AL_H, AL_B, AL_NB_ITER, AL_JAX_COST = 400, 8192, 100, 8.898e-4
AL_KP = (199, 399)
AL_ARGS = (5, 0.25, 1.1)          # lag_update_step, penalty, scaling_factor
AL_STAGED = dict(first_stage=45, bucket=512)
AL_XCHECK_ITERS = 12              # the card-vs-CPU checks: two dual updates
AL_BOUND = 2.0
# the reference tutorial pos_orn_time_sys_2nd.py: H=50, 10 iterations
T2_H, T2_B, T2_NB_ITER = 50, 2048, 10


def al_spec(torch, dtype, device):
    """bench_table.py al_h400_100it's problem: posorn, keypoints at 199 and
    399 with precision diag(QD6), H=400, dt=0.01, limits +-10 pi."""
    from ilqr_planner_torch.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_torch.systems.spec import make_spec

    kps = [PosOrnKeypoint(*T, np.diag(QD6), k) for T, k in zip((T1, T2), AL_KP)]
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn", _panda(dtype, device), kps, np.ones(7) * 1e-5,
                     AL_H, 1, dt=0.01, q0=Q0, q_max=qmax, q_min=-qmax,
                     dtype=dtype, device=device)


def al_constraints(torch, dtype, device, coupled=False):
    """A 14 x 14 with A[5, 5] = 1 and b[5] = 2 (x5 <= 2; the other rows
    zero, inert) at every step; `coupled`: x4 + x5 <= 2 in one row (does not
    fold). -> (Constraints, b as the initial duals)."""
    from ilqr_planner_torch.solvers.al_ilqr import Constraints

    A = np.zeros((14, 14))
    b = np.zeros(14)
    A[5, 5] = 1.0
    b[5] = AL_BOUND
    if coupled:
        A, b = A[5:6].copy(), b[5:6].copy()
        A[0, 4] = 1.0
    return Constraints.uniform(A, b, AL_H, dtype=dtype, device=device), b


def al_batch(batch):
    """q0 = Q0 + 0.05 N(0, 1) (seed 0, bench_table.py's _q0s), U0 = 0."""
    q0s, U0s = flagship_batch(batch)
    return q0s, np.zeros((batch, AL_H - 1, 7))


def timeopt2nd_spec(torch, dtype, device):
    """tutorials/pos_orn_time_sys_2nd.py: spacetime keypoints at 24 (t=2.5,
    Qt1) and 49 (t=5.0, Qt2) with zero velocity targets, H=50, limits +-10 pi
    and +-10, q0 = 0."""
    from ilqr_planner_torch.systems.keypoints import SpacetimeKeypoint

    qts = (np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0, .1]),
           np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, .1, .1, .1, .1]))
    kps = [SpacetimeKeypoint(*T, qt, k, t, dposition=[0, 0, 0],
                             dorientation=[0, 0, 0, 0])
           for T, qt, k, t in zip((T1, T2), qts, (T2_H // 2 - 1, T2_H - 1),
                                  (2.5, 5.0))]
    return _time2_spec("posorn_time", kps, np.zeros(7), dtype, device)


def _time2_spec(kind, kps, q0, dtype, device):
    from ilqr_planner_torch.systems.spec import make_spec

    qmax = np.ones(7) * np.pi * 10
    return make_spec(kind, _panda(dtype, device), kps, np.ones(8) * 1e-5, T2_H,
                     2, dt=None, q0=q0, q_max=qmax, q_min=-qmax,
                     dq_max=np.ones(7) * 10, dq_min=-np.ones(7) * 10,
                     dtype=dtype, device=device)


def time2_check_spec(torch, dtype, device, kind):
    """The JAX package's own time-optimal double-integrator tests
    (tests/test_fleet.py) at the tutorial's H=50: one keypoint at 49, a
    spacetime one (T1, t=2.0, Qt1, zero velocity targets) or a joint one
    (Q0 + 0.2, t=1.5), from Q0."""
    from ilqr_planner_torch.systems.keypoints import (AngularTimeKeypoint,
                                                      SpacetimeKeypoint)

    if kind == "posorn_time":
        kps = [SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0,
                                               0, 0, .1]), T2_H - 1, 2.0,
                                 dposition=[0, 0, 0], dorientation=[0, 0, 0, 0])]
    else:
        kps = [AngularTimeKeypoint(Q0 + 0.2, np.diag([1.0] * 7 + [0.01] * 7 + [0.1]),
                                   T2_H - 1, 1.5, dposition=np.zeros(7))]
    return _time2_spec(kind, kps, Q0, dtype, device)


def timeopt2nd_batch(batch):
    """x0 = [0.05 N(0, 1) (seed 1, as bench_table.py's timeopt row), 0, 0],
    U0 rows [0]*7 + [0.01]."""
    rng = np.random.default_rng(1)
    x0s = np.concatenate([0.05 * rng.normal(size=(batch, 7)),
                          np.zeros((batch, 8))], axis=-1)
    U0 = np.tile(np.array([0.0] * 7 + [0.01]), (T2_H - 1, 1))
    return x0s, np.tile(U0[None], (batch, 1, 1))


def time2_check_batch(batch):
    """The JAX tests' lanes: x0 = [Q0 + 0.02 N(0, 1) (seed 3), 0, 0], U0
    rows [0]*7 + [0.1]."""
    rng = np.random.default_rng(3)
    x0s = np.concatenate([Q0[None] + 0.02 * rng.normal(size=(batch, 7)),
                          np.zeros((batch, 8))], axis=-1)
    U0 = np.tile(np.array([0.0] * 7 + [0.1]), (T2_H - 1, 1))
    return x0s, np.tile(U0[None], (batch, 1, 1))


def _al_solve(torch, prefer_fleet=True, nb_iter=AL_NB_ITER, staged=False,
              coupled=False):
    """An AL solve as f(spec, x0s, U0s) (the duals b, the bound's
    constraints in the spec's dtype and device)."""
    from ilqr_planner_torch.parallel import solve_batch_al, solve_batch_al_staged

    def f(spec, x0s, U0s, n=nb_iter):
        cons, b = al_constraints(torch, spec.dtype, spec.device, coupled)
        if staged:
            return solve_batch_al_staged(spec, cons, b, {"x0": x0s}, U0s, n,
                                         *AL_ARGS, **AL_STAGED)
        return solve_batch_al(spec, cons, b, {"x0": x0s}, U0s, n, *AL_ARGS,
                              prefer_fleet=prefer_fleet)
    return f


def _bound_violation(X):
    """(largest x5 - 2 over lanes and steps, median over lanes of each
    lane's largest) of trajectories X [B, H, 7]."""
    per_lane = (X[:, :, 5].double() - AL_BOUND).amax(1).cpu().numpy()
    return float(per_lane.max()), float(np.median(per_lane))


def phase_al_kernel(torch):
    """segment_backward at al_h400's shape (n=7, H=400, B=8192, inner
    keypoint 199) with the folded bound in its streamed rows: on ~30% of the
    steps and lanes L2[:, 5] carries the penalty 0.25 and lx[:, 5] the
    term lam + 0.25 g, as `fleet._fold_al` adds them. -> {label: line}"""
    from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb

    hm1, kp = AL_H - 1, (AL_KP[0],)
    P0, p0, L2, lx, U, gxx = sweep_inputs(N, N, hm1, len(kp), AL_B, seed=11)
    rng = np.random.default_rng(12)
    live = rng.random((hm1, AL_B)) < 0.3
    L2[:, 5] += 0.25 * live
    lx[:, 5] += live * (rng.uniform(0.0, 2.0, (hm1, AL_B))
                        + 0.25 * rng.normal(size=(hm1, AL_B)))
    out = _kernel_vs_twin(
        torch, "segment_backward", {"n": N, "H": AL_H, "B": AL_B, "kp_inner": kp,
                                    "folded_bound": "x5 <= 2"},
        (P0, p0, L2, lx, U, gxx),
        lambda *a: sb.segment_backward(*a, kp, 0.01, [1e-5] * N),
        lambda *a: sb.segment_backward_reference(*a, kp, 0.01, [1e-5] * N),
        2, inner=3)
    out.update(bound(sweep_bytes(N, hm1, len(kp), AL_B, 4),
                     sweep_flops(N, hm1, len(kp), AL_B)))
    out["launch"] = _launch_of(
        torch, "segment_backward", lambda dt_: sb.launch_geometry(AL_B, dt_, N),
        lambda dt_: sb.kernel_geometry(AL_B, dt_, N))
    return {"segment_backward H400": _gate_kernel(out)}


def phase_al_h400(torch):
    """al_h400 through solve_batch_al_staged at full width, float32: every
    count at 0 just before the first staged solve; segment_backward once a
    backward sweep of each stage (the bound folds into the stage rows),
    nothing else; the median cost within 2x of the JAX record; the bound's
    violation; RECURSIVE_SLICE_REPEATS timed repeats."""
    spec = al_spec(torch, torch.float32, "cuda")
    q0s, U0s = al_batch(AL_B)
    x0 = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    U0 = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    solve = _al_solve(torch, staged=True)

    def run(n=AL_NB_ITER):
        return solve(spec, x0, U0, n)

    res, counts, first_s, times = _timed_runs(torch, run,
                                              RECURSIVE_SLICE_REPEATS)
    it = res.iterations.cpu().numpy()
    first = AL_STAGED["first_stage"]
    # stage 1 sweeps min(max it, first stage) times; the lanes that used
    # them all are solved again, up to their own last iteration
    sweeps = int(it.max()) if it.max() < first else first + int(it.max())
    worst, median_viol = _bound_violation(res.X)
    out = {"phase": "end_to_end", "path": "al_h400", "nb_iter": AL_NB_ITER,
           "staged": AL_STAGED,
           **_result_summary(res, AL_B, first_s, times, counts,
                             ((AL_B, AL_H, N), (AL_B, AL_H - 1, N),
                              (AL_B, AL_H, 7))),
           "iterations_p90": float(np.percentile(it, 90)),
           "iterations_max": int(it.max()),
           "lanes_restaged": int((it >= first).sum()),
           "backward_sweeps": sweeps,
           "generic_sweeps": counts["generic_sweeps"],
           "bound_violation_max": worst,
           "bound_violation_median_of_lane_max": median_viol,
           "multipliers_max": float(res.multipliers.max())}
    _gate_quality(out, "al_h400", AL_JAX_COST)
    _gate_only("al_h400", counts, sweeps)
    if counts["generic_sweeps"]:
        fail(f"al_h400: the generic sweep ran {counts['generic_sweeps']} times")
    return out, run


def phase_timeopt2nd(torch):
    """timeopt2nd through solve_batch at full width, float32: no kernel
    launches (the generic sweep, once an iteration, and the plain
    rollout); the median cost and the share of lanes whose cost is NaN (the
    reference notebook diverges to NaN on this kind); 2 timed repeats."""
    spec = timeopt2nd_spec(torch, torch.float32, "cuda")
    x0s, U0s = timeopt2nd_batch(T2_B)
    res, counts, first_s, times, run = _drive(torch, spec, x0s, U0s, T2_NB_ITER)
    cost = res.cost.double().cpu().numpy()
    nan = np.isnan(cost)
    sweeps = int(res.iterations.max())
    out = {"phase": "end_to_end", "path": "timeopt2nd", "nb_iter": T2_NB_ITER,
           **_result_summary(res, T2_B, first_s, times, counts,
                             ((T2_B, T2_H, 15), (T2_B, T2_H - 1, 8),
                              (T2_B, T2_H, 15))),
           "median_cost": float(np.median(cost[~nan])) if (~nan).any() else None,
           "nan_share": float(nan.mean()),
           "backward_sweeps": sweeps, "generic_sweeps": counts["generic_sweeps"],
           "line_search_trials": counts["trials"]}
    emit(out)
    if not out["shapes_ok"] or nan.all():
        fail("timeopt2nd: wrong shapes, or every lane's cost is NaN")
    launched = [k for k in KERNELS if counts[k]]
    if launched:
        fail(f"timeopt2nd: kernels launched: {launched}")
    if sweeps == 0 or counts["generic_sweeps"] != sweeps:
        fail(f"timeopt2nd: the generic sweep ran {counts['generic_sweeps']} "
             f"times for {sweeps} iterations")
    return out, run


def phase_generic_sweep_launches(torch):
    """One line, no gate: the device launches and the wall time of one
    generic sweep (timeopt2nd at full width, float32, on its initial
    rollout), from a profile of that sweep alone."""
    from ilqr_planner_torch.solvers import fleet

    spec = timeopt2nd_spec(torch, torch.float32, "cuda")
    x0s, U0s = timeopt2nd_batch(T2_B)
    cc = fleet._Consts(spec)
    x0 = torch.as_tensor(x0s, dtype=torch.float32, device="cuda").T.contiguous()
    U0 = torch.as_tensor(U0s, dtype=torch.float32,
                         device="cuda").permute(1, 2, 0).contiguous()
    z = x0.new_zeros
    X, U, _, _ = fleet._rollout(cc, 0.0, z((T2_H - 1, 8, 15, T2_B)),
                                z((T2_H - 1, 8, T2_B)), z((T2_H, 15, T2_B)), U0, x0)
    fleet._backward(cc, X, U)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.time()
        fleet._backward(cc, X, U)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fleet._backward(cc, X, U)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    emit({"phase": "generic_sweep", "path": "timeopt2nd", "batch": T2_B,
          "dtype": "float32", "steps": T2_H - 1, "device_launches": launches,
          "launches_a_step": launches / (T2_H - 1),
          "wall_ms_median": 1e3 * statistics.median(walls),
          "device_busy_ms": busy_ms})


def phase_al_cross_checks(torch):
    """64 lanes of al_h400's problem in float64 (12 iterations, two dual
    updates), card against CPU: the folded bound on the fleet
    (segment_backward) and on the recursive route, the two routes against
    each other on the card; the coupled bound x4 + x5 <= 2 on the fleet
    (the generic sweep with the AL terms). Then posorn_time and joint_time
    at nb_deriv 2 on the fleet (the generic sweep): one iteration without
    line search (every lane within 1e-9), four with (the spread rule)."""
    q0s, U0s = al_batch(XCHECK_B)
    gpu = {}
    for prefer, kernels in ((True, ("segment_backward",)), (False, ())):
        route = "fleet" if prefer else "recursive"
        gpu[route], _ = _card_vs_cpu(
            torch, f"al_h400_{route}", _al_solve(torch, prefer, AL_XCHECK_ITERS),
            al_spec, q0s, U0s, kernels, True, route=route,
            nb_iter=AL_XCHECK_ITERS)
    _routes_agree(torch, "al_h400", gpu,
                  lambda prefer: _al_solve(torch, prefer, AL_XCHECK_ITERS),
                  al_spec, q0s, U0s, nb_iter=AL_XCHECK_ITERS,
                  multipliers_max_abs_diff=float(
                      (gpu["fleet"].multipliers - gpu["recursive"].multipliers)
                      .abs().max()))
    _card_vs_cpu(torch, "al_h400_coupled_fleet",
                 _al_solve(torch, True, AL_XCHECK_ITERS, coupled=True), al_spec,
                 q0s, U0s, (), True, nb_iter=AL_XCHECK_ITERS,
                 constraint="x4 + x5 <= 2")
    from ilqr_planner_torch.parallel import solve_batch

    x0s, U0s2 = time2_check_batch(XCHECK_B)
    for kind in ("posorn_time", "joint_time"):
        spec_fn = (lambda t, dt_, dev, k=kind: time2_check_spec(t, dt_, dev, k))
        for nb, ls in ((1, False), (4, True)):
            _card_vs_cpu(
                torch, f"{kind}2_fleet",
                lambda spec, x, u, nb=nb, ls=ls: solve_batch(
                    spec, {"x0": x}, u, nb, line_search=ls),
                spec_fn, x0s, U0s2, (), ls, rel=XCHECK_REL if ls else 1e-9,
                nb_iter=nb, line_search=ls)


# ---------------------------------------------------------------------------
# the batch (Gauss-Newton) solver, the LQT tracker and the
# parallel-prefix backward; no hand-written kernel lies on these paths (the
# JAX package runs them outside any Pallas kernel too)
# ---------------------------------------------------------------------------

GN_B, GN_NB_ITER, GN_KP, GN_REPEATS = 4096, 10, (49, 99), 3
# bench_table.py rows batch_gn_h100_10it and batch_cp_h100_10it
GN_ROWS = {"batch_gn": "batch_gn_h100_10it", "batch_cp": "batch_cp_h100_10it"}
TIME_GN_ITERS = (8, 10)                 # GN, CP (test_batch_fast.py:107-125)
TIME_GN_U_ATOL = 1e-6                   # that test's own tolerance
LQT_N, LQT_DOF, LQT_DT, LQT_RFACTOR = 400, 7, 0.01, 0.01
LQT_KP = (199, 399)
LQT_REL = 1e-9
PSCAN_ITERS = {"golden": 10, "timeopt": 20}


def _jax_record(row):
    """The JAX package's own float32 median cost of a bench_table.py row on
    its TPU (BENCH_TABLE.json): a quality target, never a speed."""
    with open(os.path.join(REPO, "BENCH_TABLE.json")) as f:
        rows = json.load(f)["rows"]
    return next(r["median_cost"] for r in rows if r["row"] == row)


def _gn_psi(torch, dtype, device, H, nu, K=2):
    from ilqr_planner_torch.ops.primitives import build_psi_unitstep

    return torch.as_tensor(np.kron(build_psi_unitstep(H - 1, K), np.eye(nu)),
                           dtype=dtype, device=device)


def _gn_solve(torch, kp_idx, nb_iter, cp, early_stop=True):
    """solve_batch_gn as f(spec, x0s, u0s) (x0s [B, nx] numpy or tensor),
    with the unit-step primitives (K=2) when cp."""
    from ilqr_planner_torch.parallel import solve_batch_gn

    def f(spec, x0s, u0s, n=nb_iter):
        x0 = torch.as_tensor(x0s, dtype=spec.dtype, device=spec.device)
        psi = (_gn_psi(torch, spec.dtype, spec.device, spec.horizon, spec.nu)
               if cp else None)
        return solve_batch_gn(spec, kp_idx, {"x0": x0}, u0s, n, psi=psi,
                              early_stop=early_stop)
    return f


def phase_batch_gn(torch, name):
    """batch_gn / batch_cp (bench_table.py:202-235, uncut): the flagship
    problem, B=4096, 10 iterations, float32, q0 = Q0 + 0.05 N(0, 1) (seed
    0), u0 = 0; one warm-up, 3 timed repeats; every count at 0 just before
    the first solve (no hand-written kernel may launch: the batch solver
    has none); the median cost within 2x of the JAX record; launches a
    solve and the device busy share of one profiled solve."""
    cp = name == "batch_cp"
    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, _ = flagship_batch(GN_B)
    x0s = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    u0s = torch.zeros((GN_B, (H - 1) * N), dtype=torch.float32, device="cuda")
    solve = _gn_solve(torch, GN_KP, GN_NB_ITER, cp)

    def run():
        return solve(spec, x0s, u0s)

    res, counts, first_s, times = _timed_runs(torch, run, GN_REPEATS)
    kernels, wall_s, _ = _profiled(torch, name, run)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    cost = res.cost.double().cpu().numpy()
    top = sorted(kernels, key=lambda e: -_dev_us(e))[:8]
    out = {"phase": "end_to_end", "path": name, "nb_iter": GN_NB_ITER,
           "batch": GN_B, "dtype": "float32", "first_call_s": first_s,
           "repeat_times_s": times,
           "solves_per_s_median": GN_B / statistics.median(times),
           "spread_max_over_min": max(times) / min(times),
           "median_cost": float(np.median(cost)),
           "finite_costs": bool(np.isfinite(cost).all()),
           "median_iterations": float(np.median(res.iterations.cpu().numpy())),
           "launches": counts,
           "shapes_ok": (tuple(res.u.shape), tuple(res.cost.shape),
                         tuple(res.iterations.shape))
           == ((GN_B, (H - 1) * N), (GN_B,), (GN_B,)),
           "finite": bool(res.u.isfinite().all()),
           "profiled_solve": {"unprofiled_wall_ms": 1e3 * wall_s,
                              "device_busy_ms": busy_ms,
                              "device_launches": sum(e.count for e in kernels),
                              "busy_share_of_unprofiled_wall":
                                  busy_ms / 1e3 / wall_s,
                              "top_kernels": [[e.key[:80], _dev_us(e) / 1e3,
                                               e.count] for e in top]},
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    _gate_quality(out, name, _jax_record(GN_ROWS[name]))
    launched = [k for k in KERNELS if counts[k]]
    if launched:
        fail(f"{name}: hand-written kernels launched: {launched}")
    return out


def phase_gn_cross_checks(torch):
    """64 lanes, float64, card against CPU: the GN and CP problems through
    solve_batch_gn (every lane's iterations equal, cost within 1e-8 relative
    or the spread rule, u within 1e-8 of max |u|); the reference-shaped
    body on the GN problem, card against CPU and against the closed-form
    body on the card (cost within 1e-8 relative, u within 1e-8 of max |u|);
    and posorn_time at nb_deriv 1 (test_batch_fast.py:107-125, early stop
    off; GN 8 and CP 10 iterations), card against CPU, every lane's u
    within 1e-6 (the JAX test's own tolerance), or, for a lane over it,
    within 10 times its own CPU spread: the larger of its u's move under a
    1e-15 relative change of x0 (the rule of `_card_vs_cpu`, on u) and its
    distance on the CPU to the reference-shaped body (the JAX test holds
    the two bodies to 1e-6: the Woodbury step drifts by rounding)."""
    from ilqr_planner_torch.solvers import batch

    q0s, _ = flagship_batch(GN_B)
    x0s, u0s = q0s[:XCHECK_B], np.zeros((XCHECK_B, (H - 1) * N))
    for name, cp in (("batch_gn", False), ("batch_cp", True)):
        _card_vs_cpu(torch, f"{name}_card_vs_cpu",
                     lambda spec, x, u, cp=cp: _gn_solve(
                         torch, GN_KP, GN_NB_ITER, cp)(spec, x, u),
                     flagship_spec, x0s, u0s, (), True, u_rel=XCHECK_REL)

    def reference(spec, x, u):
        x = torch.as_tensor(x, dtype=spec.dtype, device=spec.device)
        u = torch.as_tensor(u, dtype=spec.dtype, device=spec.device)
        return batch._solve_impl(spec, batch.sparse_Q(spec, GN_KP), None, x,
                                 u, GN_KP, GN_NB_ITER, True, False, False)

    ref, spec_gpu = _card_vs_cpu(torch, "batch_gn_reference_body", reference,
                                 flagship_spec, x0s, u0s, (), True,
                                 u_rel=XCHECK_REL)
    fast = _gn_solve(torch, GN_KP, GN_NB_ITER, False)(spec_gpu, x0s, u0s)
    rel = (ref.cost - fast.cost).abs() / fast.cost.abs()
    out = {"phase": "reference_vs_closed_form_body", "batch": XCHECK_B,
           "dtype": "float64", "device": "cuda",
           "same_iterations": bool(torch.equal(ref.iterations, fast.iterations)),
           "cost_max_rel_diff": float(rel.max()),
           "u_max_abs_diff": float((ref.u - fast.u).abs().max()),
           "u_max_abs": float(fast.u.abs().max()), "tolerance": XCHECK_REL}
    emit(out)
    if not (out["same_iterations"] and out["cost_max_rel_diff"] <= XCHECK_REL
            and out["u_max_abs_diff"] <= XCHECK_REL * out["u_max_abs"]):
        fail("the reference-shaped and closed-form bodies disagree on the card")

    tx0s, tU0s = timeopt_batch(XCHECK_B)
    tu0s = tU0s.reshape(XCHECK_B, -1)
    for cp, nb in zip((False, True), TIME_GN_ITERS):
        solve = _gn_solve(torch, GN_KP, nb, cp, early_stop=False)
        res = {dev: solve(timeopt_spec(torch, torch.float64, dev), tx0s,
                          torch.as_tensor(tu0s, device=dev))
               for dev in ("cuda", "cpu")}
        g, c = res["cuda"], res["cpu"]
        diff = (g.u.cpu() - c.u).abs().max(-1).values.numpy()
        tol = np.full(XCHECK_B, TIME_GN_U_ATOL)
        over = np.flatnonzero(diff > TIME_GN_U_ATOL)
        out = {"phase": "card_vs_cpu", "path": f"timeopt_{'cp' if cp else 'gn'}",
               "batch": XCHECK_B, "dtype": "float64", "nb_iter": nb,
               "early_stop": False,
               "same_iterations": bool(np.array_equal(g.iterations.cpu().numpy(),
                                                      c.iterations.numpy())),
               "u_max_abs_diff": float(diff.max()),
               "u_median_abs_diff": float(np.median(diff)),
               "u_tolerance": TIME_GN_U_ATOL,
               "cost_max_rel_diff": float(((g.cost.cpu() - c.cost).abs()
                                           / c.cost.abs()).max()),
               "median_cost": float(c.cost.median())}
        if over.size:
            # the lane's own CPU spread: the larger of its largest |u| move
            # when x0 (its joint positions) moves by 1e-15 relative, up or
            # down, and its distance to the reference-shaped body's u, the
            # same step computed in another algebraically equal order
            spec = timeopt_spec(torch, torch.float64, "cpu")
            spread = np.zeros(XCHECK_B)
            for sign in (1.0, -1.0):
                x0p = tx0s.copy()
                x0p[:, :7] *= 1.0 + sign * XCHECK_PERTURB
                moved = solve(spec, x0p, torch.as_tensor(tu0s))
                spread = np.maximum(spread, (moved.u - c.u).abs().max(-1)
                                    .values.numpy())
            psi = _gn_psi(torch, torch.float64, "cpu", spec.horizon,
                          spec.nu) if cp else None
            ref = batch._solve_impl(spec, batch.sparse_Q(spec, GN_KP), psi,
                                    torch.as_tensor(tx0s),
                                    torch.as_tensor(tu0s), GN_KP, nb, False,
                                    cp, False)
            bodies = (ref.u - c.u).abs().max(-1).values.numpy()
            tol[over] = np.maximum(TIME_GN_U_ATOL, XCHECK_SENS_FACTOR
                                   * np.maximum(spread, bodies)[over])
            out["lanes_over_1e-6"] = [
                {"lane": int(i), "u_abs_diff": float(diff[i]),
                 "cpu_u_spread_x0": float(spread[i]),
                 "cpu_u_reference_body": float(bodies[i]),
                 "tolerance": float(tol[i])} for i in over]
        out["lanes_over_tolerance"] = [int(i) for i in np.flatnonzero(diff > tol)]
        emit(out)
        if not out["same_iterations"] or out["lanes_over_tolerance"]:
            fail(f"{out['path']}: card and CPU disagree")


def lqt_system(torch, device):
    """lqt_h400: the 7-joint double integrator (nx=14, nu=7, dt=0.01,
    A = [[I, dt I], [0, I]], B = [[dt^2/2 I], [dt I]]), N=400, Qs = I at
    steps 199 and 399 and zero elsewhere, joint targets there from
    N(0, 0.5) (numpy seed 0) with zero velocity, rfactor 0.01, float64."""
    from ilqr_planner_torch.solvers.lqt import LQT

    d, dt = LQT_DOF, LQT_DT
    eye = np.eye(d)
    A = np.block([[eye, dt * eye], [np.zeros((d, d)), eye]])
    Bm = np.vstack([0.5 * dt * dt * eye, dt * eye])
    Qs = np.zeros((LQT_N, 2 * d, 2 * d))
    mu = np.zeros((LQT_N, 2 * d))
    rng = np.random.default_rng(0)
    for k in LQT_KP:
        Qs[k] = np.eye(2 * d)
        mu[k, :d] = 0.5 * rng.normal(size=d)
    return LQT(A, Bm, Qs, mu.reshape(-1), LQT_RFACTOR, device=device)


def phase_lqt(torch):
    """lqt_h400 on the card and on the CPU, float64: solve_dp(), solve_dp(
    parallel=True) and solve_linalg(), each card result within 1e-9 of the
    largest CPU value (value Hessians, feedforward terms, commands at steps
    0, 199 and 398 from the same state, the batch controls and predicted
    states); the sequential and parallel DP within 1e-8 of each other on
    the card; the card's wall of each (a second call, not gated)."""
    x = np.random.default_rng(1).normal(size=2 * LQT_DOF)
    steps = (0, LQT_KP[0], LQT_N - 2)
    got, walls = {}, {}
    for dev in ("cuda", "cpu"):
        for method in ("dp", "dp_parallel", "linalg"):
            lqt = lqt_system(torch, dev)
            fn = {"dp": lqt.solve_dp,
                  "dp_parallel": lambda lqt=lqt: lqt.solve_dp(parallel=True),
                  "linalg": lqt.solve_linalg}[method]
            for _ in range(2):                      # the second call timed
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.time()
                fn()
                if dev == "cuda":
                    torch.cuda.synchronize()
                walls[dev, method] = time.time() - t0
            if method == "linalg":
                vals = {"u": lqt._u, "commands": torch.stack(
                    [lqt.get_command(t) for t in steps]),
                        "predicted_states": lqt.get_predicted_states()}
            else:
                vals = {"Ps": lqt._Ps, "ds": lqt._ds, "commands": torch.stack(
                    [lqt.get_command(t, x) for t in steps])}
            got[dev, method] = {k: v.cpu() for k, v in vals.items()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {"phase": "lqt_h400", "N": LQT_N, "nx": 2 * LQT_DOF, "nu": LQT_DOF,
           "dtype": "float64", "tolerance_card_vs_cpu": LQT_REL,
           "card_vs_cpu_max_rel": {
               m: {k: rel(got["cuda", m][k], got["cpu", m][k])
                   for k in got["cpu", m]}
               for m in ("dp", "dp_parallel", "linalg")},
           "sequential_vs_parallel_on_card_max_rel": {
               k: rel(got["cuda", "dp_parallel"][k], got["cuda", "dp"][k])
               for k in ("Ps", "ds", "commands")},
           "card_wall_ms": {m: 1e3 * walls["cuda", m]
                            for m in ("dp", "dp_parallel", "linalg")},
           "cpu_wall_ms": {m: 1e3 * walls["cpu", m]
                           for m in ("dp", "dp_parallel", "linalg")}}
    emit(out)
    worst = max(v for d in out["card_vs_cpu_max_rel"].values() for v in d.values())
    if not worst <= LQT_REL:
        fail(f"lqt_h400: card and CPU differ by {worst} (> {LQT_REL})")
    if not max(out["sequential_vs_parallel_on_card_max_rel"].values()) <= 1e-8:
        fail("lqt_h400: the sequential and parallel DP disagree on the card")


def _pscan_problem(torch, name, dtype, device):
    """(spec, U0, nb_iter): test_pscan.py's golden problem (the flagship
    spec, one problem) or its time-optimal one (H=100)."""
    if name == "golden":
        return (flagship_spec(torch, dtype, device), np.zeros((H - 1, N)),
                PSCAN_ITERS[name])
    _, U0s = timeopt_batch(1)
    return timeopt_spec(torch, dtype, device), U0s[0], PSCAN_ITERS[name]


def phase_pscan(torch):
    """ilqr.solve(backward='pscan') on test_pscan.py's golden problem (10
    iterations) and time-optimal one (20): float64 card against CPU (equal
    iterations, cost within 1e-8 relative, or, over it, within 10 times
    the CPU cost's own move under a 1e-15 relative change of U0, up or
    down, where that exceeds 1e-9: the time-optimal solve amplifies
    rounding); pscan against scan on the card within the JAX test's
    tolerances; riccati launched by the scan route only (once an
    iteration on the golden problem); float32 walls of both, not gated."""
    from ilqr_planner_torch.solvers import ilqr

    for name in PSCAN_ITERS:
        res, counts = {}, {}
        for dev, bw in (("cuda", "pscan"), ("cuda", "scan"), ("cpu", "pscan")):
            spec, U0, nb = _pscan_problem(torch, name, torch.float64, dev)
            _reset_counts()
            res[dev, bw] = ilqr.solve(spec, U0, nb, backward=bw)
            counts[bw] = counts.get(bw, 0) + _read_counts()["riccati"]
        g, s, c = res["cuda", "pscan"], res["cuda", "scan"], res["cpu", "pscan"]
        rel = abs(float(g.cost) - float(c.cost)) / abs(float(c.cost))
        spread, tol = None, XCHECK_REL
        if rel > XCHECK_REL:
            spec_cpu, U0, nb = _pscan_problem(torch, name, torch.float64, "cpu")
            spread = max(abs(float(ilqr.solve(
                spec_cpu, U0 * (1 + sign * XCHECK_PERTURB), nb,
                backward="pscan").cost) / float(c.cost) - 1)
                for sign in (1.0, -1.0))
            if spread > 1e-9:
                tol = max(XCHECK_REL, XCHECK_SENS_FACTOR * spread)
        walls = {}
        for bw in ("scan", "pscan"):
            spec32, U0, nb = _pscan_problem(torch, name, torch.float32, "cuda")
            for _ in range(2):                      # the second call timed
                torch.cuda.synchronize()
                t0 = time.time()
                ilqr.solve(spec32, U0, nb, backward=bw)
                torch.cuda.synchronize()
                walls[bw] = time.time() - t0
        out = {"phase": "pscan", "problem": name, "nb_iter": nb,
               "card_vs_cpu_f64": {
                   "same_iterations": int(g.iterations) == int(c.iterations),
                   "iterations": int(c.iterations), "cost_rel_diff": rel,
                   "cpu_spread": spread, "tolerance": tol,
                   "U_max_abs_diff": float((g.U.cpu() - c.U).abs().max())},
               "pscan_vs_scan_on_card_f64": {
                   "pscan_cost": float(g.cost), "scan_cost": float(s.cost),
                   "cost_rel_diff": abs(float(g.cost) / float(s.cost) - 1),
                   "X_max_abs_diff": float((g.X - s.X).abs().max()),
                   "U_max_abs_diff": float((g.U - s.U).abs().max())},
               "riccati_launches_on_card": counts,
               "card_wall_ms_f32": {bw: 1e3 * walls[bw] for bw in walls}}
        emit(out)
        cv = out["card_vs_cpu_f64"]
        if not (cv["same_iterations"] and cv["cost_rel_diff"] <= tol):
            fail(f"pscan {name}: card and CPU disagree")
        ps = out["pscan_vs_scan_on_card_f64"]
        # the JAX test's own tolerances (test_pscan.py:116-121, :142-146)
        if name == "golden":
            ok = (ps["pscan_cost"] < 1e-5 and ps["cost_rel_diff"] <= 1e-4
                  and ps["X_max_abs_diff"] <= 2e-3
                  and ps["U_max_abs_diff"] <= 2e-3)
        else:
            ok = (ps["pscan_cost"] < 1e-4 and ps["cost_rel_diff"] <= 5e-3
                  and ps["X_max_abs_diff"] <= 2e-2)
        if not ok:
            fail(f"pscan {name}: pscan and scan disagree on the card")
        if counts["pscan"] or (name == "golden"
                               and counts["scan"] != int(s.iterations)):
            fail(f"pscan {name}: riccati must launch once an iteration on the "
                 f"scan route and never on the pscan route: {counts}")


# ---------------------------------------------------------------------------
# pylqr: the reference's PyLQR API (ilqr_planner_torch.compat), float64, as
# a tutorial script calls it
# ---------------------------------------------------------------------------

# POS_ORN_SYS.ipynb's stored output (cell 12): ILQRRecursive's 8 costs; the
# first BatchILQRCP cost (cell 14); the guarded 8th iteration keeps the 7th
PYLQR_GOLDEN = [0.214194, 0.0531093, 0.00372911, 0.000499702, 3.5657e-06,
                9.81748e-07, 9.80374e-07, 9.80376e-07]
PYLQR_CP_FIRST = 0.506613
PYLQR_GUARD_COST = 9.80374e-07
PYLQR_RTOL = 2e-4
PYLQR_REL = 1e-9             # card vs CPU, float64, one problem
PYLQR_U_REL = 1e-8           # the batch solvers' u, of max |u|
TIME2_LAST_FINITE = 2.91514  # the notebook's last finite cost (cell 11)
QMAX_TUT = np.ones(7) * np.pi * 10


def _max_rel(a, b):
    """max |a - b| / max |b| of two numpy arrays."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pylqr_robot(compat, device, q0=Q0):
    from ilqr_planner_torch.models import PANDA_URDF

    return compat.sim.KDLRobot(PANDA_URDF.read_text(), "panda_link0",
                               "panda_tip", list(q0), [0.0] * N,
                               is_path=False, device=device)


def _pylqr_posorn(compat, device, horizon, dt, q0=Q0):
    """POS_ORN_SYS.ipynb cells 2-12 at (horizon, dt): the two via-points at
    horizon/2 - 1 and horizon - 1, limits +-10 pi -> (robot, system)."""
    rbt = _pylqr_robot(compat, device, q0)
    qd = np.diag(QD6)
    kps = [compat.system.PosOrnKeypoint(np.array(T1[0]), np.array(T1[1]), qd,
                                        horizon // 2 - 1),
           compat.system.PosOrnKeypoint(np.array(T2[0]), np.array(T2[1]), qd,
                                        horizon - 1)]
    return rbt, compat.system.PosOrnPlannerSys(
        rbt, kps, [1e-5] * N, QMAX_TUT, -QMAX_TUT, horizon, 1, dt)


def _pylqr_multi(compat, device):
    """POS_ORN_MULTI_SYS.ipynb: two TransformedSimulationInterfaces over one
    robot (object frames 1 and 2), position-only via-points at 300 and 599
    in their frames, H=600, dt=0.01, joint and velocity limits, combined by
    a SequentialSystem."""
    rbt = _pylqr_robot(compat, device)
    obj1, obj2 = _frames()
    qd = np.diag([1, 1, 1, 0, 0, 0])
    cmd = [1e-5] * N
    lim = (QMAX_TUT, -QMAX_TUT, np.ones(N) * 10, -np.ones(N) * 10)
    subs = []
    for T, target, k in ((obj1, [0.0, 0.0, -0.15], SEQ_H // 2),
                         (obj2, [0.1, 0.1, -0.1], SEQ_H - 1)):
        tr = compat.sim.TransformedSimulationInterface(rbt, T)
        kp = compat.system.PosOrnKeypoint(np.array(target),
                                          np.array([1.0, 0, 0, 0]), qd, k)
        subs.append(compat.system.PosOrnPlannerSys(tr, [kp], cmd, *lim, SEQ_H,
                                                   1, 0.01))
    return rbt, compat.system.SequentialSystem(rbt, subs, cmd, SEQ_H, 1)


def _pylqr_time2(compat, device, H2=50):
    """POS_ORN_TIME_SYS_2ND.ipynb (tests/test_systems_extra.py:175-200):
    the time-optimal double integrator from the zero configuration,
    spacetime via-points at 24 (t=2.5) and 49 (t=5), H=50."""
    rbt = _pylqr_robot(compat, device, np.zeros(N))
    z3, z4 = np.zeros(3), np.zeros(4)
    kps = [compat.system.SpacetimeKeypoint(
        np.array(T1[0]), z3, np.array(T1[1]), z4,
        np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, 0, 0, 0, .1]), 2.5, H2 // 2 - 1),
        compat.system.SpacetimeKeypoint(
        np.array(T2[0]), z3, np.array(T2[1]), z4,
        np.diag([1, 1, 1, .1, .1, .1, 1, 1, 1, .1, .1, .1, .1]), 5.0, H2 - 1)]
    dq = np.ones(N) * 10.0
    sys_ = compat.system.PosOrnTimePlannerSys(
        rbt, kps, [1e-5] * (N + 1), QMAX_TUT, -QMAX_TUT, dq, -dq, H2, 2)
    return sys_, np.tile(np.array([0.0] * N + [0.01]), (H2 - 1, 1))


def _progress(cb):
    """(iteration, cost, alpha) of each message a MetricsCallback heard."""
    return [(r.get("iteration"), r.get("cost"), r.get("alpha"))
            for r in cb.records]


def _syncs(torch, fn):
    """Host syncs that fn() makes, as torch.cuda.set_sync_debug_mode("warn")
    reports them (the mode is switched on outside the count: the first
    switch in a process reports one of its own)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _timed_solve(torch, fn, meter=None):
    """fn() with every count at 0 just before it, inside `meter` (a
    CompileMeter) when one is given -> (its result, wall s, the counts just
    after)."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with meter or contextlib.nullcontext():
        out = fn()
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _read_counts()


def _timed_runs(torch, run, repeats=None, meter=None):
    """run() with every count at 0 just before it (inside `meter` when one
    is given), then `repeats` (default REPEATS) timed ones -> (the last
    result, the first run's counts, its seconds, the repeats' seconds)."""
    res, first_s, counts = _timed_solve(torch, run, meter)
    times = []
    for _ in range(REPEATS if repeats is None else repeats):
        res, t, _ = _timed_solve(torch, run)
        times.append(t)
    return res, counts, first_s, times


def _gate_pylqr(out, ok, what):
    emit(out)
    if not ok:
        fail(f"pylqr {out['problem']}: {what}")


def phase_pylqr(torch):
    """The PyLQR drop-in API on the card, float64, as the tutorials call it
    (`ilqr_planner_torch.compat`): POS_ORN_SYS (ILQRRecursive with a
    MetricsCallback: the notebook's 8 costs at rtol 2e-4, riccati once an
    iteration and no other kernel, X, U and cost within 1e-9 relative of
    the same solve on the CPU; the host syncs of the solve without and
    with a callback; two solves on two threads, each callback hearing its
    own iterations on its own thread; BatchILQR and BatchILQRCP with
    callbacks: the first CP
    cost 0.506613, u within 1e-8 of max |u| of the CPU's, the closed-form
    body's syncs the same at 2 and 10 iterations; the send_vel replay;
    guard=True: 8 iterations ending at 9.80374e-07), POS_ORN_SYS_AL_ILQR
    (H=400: max x5 <= 2.01, the plain cost card vs CPU within 1e-8 or the
    spread rule), POS_ORN_TIME_SYS_2ND with guard=True (finite, <= 2.91514,
    <= the one-iteration guarded cost; the unguarded NaN state reported),
    POS_ORN_MULTI_SYS (riccati at (7, 12), card vs CPU 1e-9); then riccati
    at B=1 against its twin. -> (riccati's kernel-vs-twin line at B=1, its
    launches in the POS_ORN_SYS solve)."""
    from ilqr_planner_torch import compat
    from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
    from ilqr_planner_torch.solvers import ilqr
    from ilqr_planner_torch.utils import MetricsCallback

    solver = compat.solver
    u0 = np.zeros((H - 1, N))
    sys_of = {dev: _pylqr_posorn(compat, dev, H, 0.1) for dev in ("cuda", "cpu")}

    # POS_ORN_SYS: the recursive solver with a callback
    cbs, runs = {}, {}
    for dev in ("cuda", "cpu"):
        cbs[dev] = MetricsCallback()
        runs[dev] = _timed_solve(torch, lambda: solver.ILQRRecursive(
            sys_of[dev][1]).solve(u0, 10, True, True, cbs[dev]))
    (gX, gF, gU, _, _, gcost), wall, counts = runs["cuda"]
    cX, _, cU, _, _, ccost = runs["cpu"][0]
    costs = cbs["cuda"].costs
    spec = sys_of["cuda"][1].spec
    _reset_counts()
    without = _syncs(torch, lambda: ilqr.solve(spec, u0, 10))
    trials = _read_counts()["recursive_trials"]
    heard = MetricsCallback()
    with_cb = _syncs(torch, lambda: ilqr.solve(spec, u0, 10, callback=heard))
    # the solver's own reads, as the parent's loop makes them: U0's copy to
    # the card, Rt and dt once, active.any() once an iteration and once to
    # end, accepted.all() before each trial and once more where a trial
    # was accepted before the last (alpha above 2^-10)
    its = len(heard.records)
    parent = (1 + 2 + its + 1 + trials
              + sum(a > 2.0 ** -10 for a in heard.alphas))
    _, again, _ = _timed_solve(torch, lambda: solver.ILQRRecursive(
        sys_of["cuda"][1]).solve(u0, 10, True, True, MetricsCallback()))
    out = {"phase": "pylqr", "problem": "pos_orn_sys", "H": H, "dtype": "float64",
           "first_call_s": wall, "wall_s": again, "iterations": len(costs),
           "costs": costs,
           "golden": PYLQR_GOLDEN, "launches": counts,
           "card_vs_cpu_rel": {"X": _max_rel(gX, cX), "U": _max_rel(gU, cU),
                               "cost": abs(gcost / ccost - 1)},
           "messages_card_equal_cpu": _progress(cbs["cuda"])
           == _progress(cbs["cpu"]),
           "host_syncs": {"callback_none": without, "callback": with_cb,
                          "iterations": its, "trials": trials,
                          "parent_loop_reads": parent},
           "fX_shape": list(gF.shape)}
    others = [k for k in KERNELS if counts[k] and k != "riccati"]
    _gate_pylqr(out, len(costs) == len(PYLQR_GOLDEN)
                and np.allclose(costs, PYLQR_GOLDEN, rtol=PYLQR_RTOL, atol=0)
                and counts["riccati"] == len(costs) and not others
                and max(out["card_vs_cpu_rel"].values()) <= PYLQR_REL
                and out["messages_card_equal_cpu"]
                and with_cb - without == its == len(costs)
                and without == parent,
                "recursive solve: costs, riccati launches, card vs CPU or "
                "host syncs off")
    riccati_launches = counts["riccati"]

    # two solves on two threads with their own callbacks, on the card
    import threading

    iters = (4, 6)
    heard = [[], []]
    errors = []

    def run(i):
        me = threading.get_ident()

        class Own:
            def notify(self, msg):
                heard[i].append((msg, threading.get_ident() == me))
        try:
            solver.ILQRRecursive(sys_of["cuda"][1]).solve(
                u0, iters[i], True, False, Own())
        except Exception as e:  # reported by the gate below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    streams = [[int(m.split(",")[0].split()[1]) for m, _ in h] for h in heard]
    out = {"phase": "pylqr", "problem": "pos_orn_sys_two_threads",
           "iterations": list(iters), "heard": streams, "errors": errors,
           "own_thread": all(own for h in heard for _, own in h)}
    _gate_pylqr(out, not errors and out["own_thread"]
                and not any(t.is_alive() for t in threads)
                and streams == [list(range(1, n + 1)) for n in iters],
                "threaded solves' callbacks interleaved or failed")

    # BatchILQR and BatchILQRCP with callbacks (the reference-shaped body)
    psi = np.kron(compat.utils.primitives.build_psi_unitstep(H - 1, 2),
                  np.eye(N))
    for name, make in (("batch_ilqr", lambda s: solver.BatchILQR(s)),
                       ("batch_ilqr_cp", lambda s: solver.BatchILQRCP(s, psi))):
        us, walls, counts, heard = {}, {}, {}, {}
        for dev in ("cuda", "cpu"):
            heard[dev] = MetricsCallback()
            us[dev], walls[dev], counts[dev] = _timed_solve(torch, lambda: make(
                sys_of[dev][1]).solve(10, np.zeros((H - 1) * N), True,
                                      heard[dev]))
        cb_costs = {dev: cb.costs for dev, cb in heard.items()}
        from ilqr_planner_torch.solvers import batch

        kp = tuple(sys_of["cuda"][1].get_kp_indexes())
        psi_t = torch.as_tensor(psi, device="cuda") if name.endswith("cp") else None

        def closed_form(n):
            return _syncs(torch, lambda: batch._solve_impl(
                spec, batch.sparse_Q(spec, kp), psi_t, spec.x0[None],
                torch.zeros((1, (H - 1) * N), dtype=spec.dtype, device="cuda"),
                kp, n, False, psi_t is not None, True))
        out = {"phase": "pylqr", "problem": f"pos_orn_sys_{name}",
               "wall_s": walls["cuda"], "iterations": len(cb_costs["cuda"]),
               "costs": cb_costs["cuda"], "launches": counts["cuda"],
               "u_max_abs_diff_over_max_abs": _max_rel(us["cuda"], us["cpu"]),
               "messages_card_equal_cpu": _progress(heard["cuda"])
               == _progress(heard["cpu"]),
               "closed_form_host_syncs": {"nb_iter_2": closed_form(2),
                                          "nb_iter_10": closed_form(10)}}
        sy = out["closed_form_host_syncs"]
        _gate_pylqr(out, out["u_max_abs_diff_over_max_abs"] <= PYLQR_U_REL
                    and out["messages_card_equal_cpu"]
                    and sy["nb_iter_2"] == sy["nb_iter_10"]
                    and not any(counts["cuda"][k] for k in KERNELS)
                    and (name != "batch_ilqr_cp" or math.isclose(
                        cb_costs["cuda"][0], PYLQR_CP_FIRST, rel_tol=PYLQR_RTOL)),
                    "batch solver: u, costs, syncs or launches off")
        if name == "batch_ilqr_cp":
            U_cp = us["cuda"].reshape(H - 1, N)

    # the replay loop (cell 14) on the card's robot mirror
    rbt = sys_of["cuda"][0]
    rbt.set_conf(Q0, np.zeros(N), True)
    t0 = time.time()
    F = [np.hstack((rbt.get_ee_pos(), rbt.get_ee_orn()))]
    for i in range(H - 1):
        rbt.send_vel(0.1, U_cp[i], True)
        F.append(np.hstack((rbt.get_ee_pos(), rbt.get_ee_orn())))
    F = np.array(F)
    out = {"phase": "pylqr", "problem": "pos_orn_sys_replay", "steps": H - 1,
           "wall_s": time.time() - t0,
           "via_point_errors": [float(np.abs(F[H // 2 - 1, :3] - T1[0]).max()),
                                float(np.abs(F[H - 1, :3] - T2[0]).max())],
           "tolerances": [2e-2, 5e-3]}
    _gate_pylqr(out, all(e <= t for e, t in zip(out["via_point_errors"],
                                                out["tolerances"])),
                "the replayed trajectory misses a via-point")

    # guard=True on the same problem
    cb = MetricsCallback()
    res, wall, counts = _timed_solve(torch, lambda: solver.ILQRRecursive(
        sys_of["cuda"][1]).solve(u0, 10, True, True, cb, guard=True))
    out = {"phase": "pylqr", "problem": "pos_orn_sys_guard", "wall_s": wall,
           "iterations": len(cb.costs), "costs": cb.costs, "cost": res[5],
           "unguarded_cost": gcost, "launches": counts}
    _gate_pylqr(out, len(cb.costs) == 8 and math.isclose(
        res[5], PYLQR_GUARD_COST, rel_tol=PYLQR_RTOL) and res[5] <= gcost,
        "guard=True: iterations or final cost off")

    # POS_ORN_SYS_AL_ILQR at the tutorial's size
    from ilqr_planner_torch.solvers.ilqr import _traj_cost

    def al_run(dev, q0=Q0, unconstrained=False):
        """The AL solve, timed once; with `unconstrained`, the tutorial's
        plain solve before it (the card's first run only)."""
        _, s = _pylqr_posorn(compat, dev, AL_H, 0.01, q0)
        ua = np.zeros((AL_H - 1, N))
        A, b = np.zeros((2 * N, 2 * N)), np.zeros(2 * N)
        A[5, 5], b[5] = 1.0, AL_BOUND
        cons = []
        for _ in range(AL_H - 1):
            c = solver.Constraint()
            c.A, c.b = A, b
            cons.append(c)
        cb1, cb2 = MetricsCallback(), MetricsCallback()
        X1 = w1 = n1 = None
        if unconstrained:
            (X1, _, _, _, _, _), w1, n1 = _timed_solve(
                torch, lambda: solver.ILQRRecursive(s).solve(ua, 10, True, True,
                                                             cb1))
        (X2, F2, U2), w2, n2 = _timed_solve(
            torch, lambda: solver.AL_ILQR(s, cons, [b] * (AL_H - 1)).solve(
                ua, 100, 5, .25, 1.1, True, True, cb2))
        t = [torch.as_tensor(a, dtype=torch.float64)[None] for a in (X2, F2, U2)]
        cost = float(_traj_cost(s.spec, *(a.to(s.spec.device) for a in t)))
        return {"X1": X1, "X2": X2, "U2": U2, "cost": cost, "walls": (w1, w2),
                "launches": (n1, n2), "iterations": (len(cb1.costs),
                                                     len(cb2.costs))}
    al = {"cuda": al_run("cuda", unconstrained=True), "cpu": al_run("cpu")}
    rel = abs(al["cuda"]["cost"] / al["cpu"]["cost"] - 1)
    spread, tol = None, XCHECK_REL
    if rel > XCHECK_REL:
        spread = max(abs(al_run("cpu", Q0 * (1 + sg * XCHECK_PERTURB))["cost"]
                         / al["cpu"]["cost"] - 1) for sg in (1.0, -1.0))
        if spread > 1e-9:
            tol = max(XCHECK_REL, XCHECK_SENS_FACTOR * spread)
    g = al["cuda"]
    out = {"phase": "pylqr", "problem": "pos_orn_sys_al_ilqr", "H": AL_H,
           "dt": 0.01, "wall_s": {"ilqr": g["walls"][0], "al_ilqr": g["walls"][1]},
           "cpu_wall_s": {"al_ilqr": al["cpu"]["walls"][1]},
           "iterations": {"ilqr": g["iterations"][0], "al_ilqr": g["iterations"][1]},
           "launches": {"ilqr": g["launches"][0], "al_ilqr": g["launches"][1]},
           "max_x5": {"unconstrained": float(g["X1"][:, 5].max()),
                      "al_ilqr": float(g["X2"][:, 5].max())},
           "bound": AL_BOUND, "tutorial_gate": AL_BOUND + 1e-2,
           "card_vs_cpu": {"cost_rel": rel, "cpu_spread": spread,
                           "tolerance": tol, "cost": g["cost"],
                           "U_max_abs_diff": float(np.abs(
                               g["U2"] - al["cpu"]["U2"]).max()),
                           "same_iterations": g["iterations"][1]
                           == al["cpu"]["iterations"][1]}}
    _gate_pylqr(out, out["max_x5"]["al_ilqr"] <= AL_BOUND + 1e-2
                and rel <= tol and out["card_vs_cpu"]["same_iterations"],
                "AL tutorial: bound, iterations or card vs CPU off")

    # POS_ORN_TIME_SYS_2ND with guard=True (and the unguarded NaN state)
    s2, U2_0 = _pylqr_time2(compat, "cuda")
    cb = MetricsCallback()
    res, wall, counts = _timed_solve(torch, lambda: solver.ILQRRecursive(
        s2).solve(U2_0, 20, True, True, cb, guard=True))
    one = solver.ILQRRecursive(s2).solve(U2_0, 1, True, False, None, guard=True)
    cb_plain = MetricsCallback()
    plain = solver.ILQRRecursive(s2).solve(U2_0, 20, True, True, cb_plain)
    out = {"phase": "pylqr", "problem": "pos_orn_time_sys_2nd_guard", "H": 50,
           "wall_s": wall, "iterations": len(cb.costs), "costs": cb.costs,
           "cost": res[5], "one_iteration_cost": one[5], "launches": counts,
           "finite": bool(np.isfinite(res[2]).all() and np.isfinite(res[0]).all()),
           "unguarded": {"cost": plain[5], "iterations": len(cb_plain.costs),
                         "first_nan_iteration": next(
                             (r["iteration"] for r in cb_plain.records
                              if math.isnan(r["cost"])), None)}}
    _gate_pylqr(out, out["finite"] and math.isfinite(res[5])
                and res[5] <= TIME2_LAST_FINITE and res[5] <= one[5] + 1e-12,
                "guard=True on the sqrt(dt) workload")

    # POS_ORN_MULTI_SYS: riccati at (7, 12)
    ms = {}
    for dev in ("cuda", "cpu"):
        _, seq = _pylqr_multi(compat, dev)
        cb = MetricsCallback()
        ms[dev] = _timed_solve(torch, lambda: solver.ILQRRecursive(seq).solve(
            np.zeros((SEQ_H - 1, N)), 10, True, True, cb)) + (cb.costs, seq)
    (mX, _, mU, _, _, mcost), wall, counts, mcosts, seq = ms["cuda"]
    cX, _, cU, _, _, ccost = ms["cpu"][0]
    out = {"phase": "pylqr", "problem": "pos_orn_multi_sys", "H": SEQ_H,
           "riccati_width": [seq.spec.nx, seq.spec.nq_var], "wall_s": wall,
           "iterations": len(mcosts), "costs": mcosts, "launches": counts,
           "card_vs_cpu_rel": {"X": _max_rel(mX, cX), "U": _max_rel(mU, cU),
                               "cost": abs(mcost / ccost - 1)}}
    _gate_pylqr(out, out["riccati_width"] == [N, 12]
                and counts["riccati"] == len(mcosts) > 0
                and max(out["card_vs_cpu_rel"].values()) <= PYLQR_REL,
                "sequential system: riccati launches or card vs CPU off")

    # riccati at B = 1, the batch of every compat solve
    Rt = [1e-5] * N
    kv = _kernel_vs_twin(
        torch, "riccati", {"n": N, "nq": NQ, "H": H, "B": 1, "prec_steps": 2},
        riccati_inputs(1) + (riccati_prec(False),),
        lambda *a: ric.riccati_backward(*a, Rt, 0.1),
        lambda *a: ric.riccati_backward_reference(*a, Rt, 0.1), 2, inner=5)
    kv.update(bound(riccati_bytes(N, NQ, H, 1, 4), riccati_flops(N, NQ, H, 1)))
    kv["launch"] = _launch_of(torch, "riccati",
                              lambda dt_: ric.launch_geometry(1, dt_, N, NQ),
                              lambda dt_: ric.kernel_geometry(1, dt_, N, NQ))
    return _gate_kernel(kv), riccati_launches


# ---------------------------------------------------------------------------
# per-lane overrides of every Spec leaf; sharded, chunked and spmd solves
# ---------------------------------------------------------------------------

# the Panda's joint limits (models/data/panda.urdf)
PANDA_LO = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175,
                     -2.8973])
PANDA_HI = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973])
F5_SEED = 12
F5_LIMIT_LEAVES = ("state_min", "state_max", "penalty", "kp_mask")
F5_SOLVER_LEAVES = ("Rt", "dt", "state_max")   # the AL and GN checks
# float32 lanes whose recursion overflows to NaN under binding limits: the
# JAX package's own float32 recursive solve does so on 1 of the first 256
# lanes of the limits-and-mask problem on the CPU (float64: none)
F5_NAN_SHARE_GATE = 0.05
CHUNK = 1024


def f5_overrides(batch, names=None, dt=0.1):
    """Per-lane leaves of the flagship problem, float64 numpy, made from a
    fixed seed: Rt log-uniform in [1e-6, 1e-4], dt U(0.8, 1.2) times the
    problem's, the Panda's joint limits with each lane's range shrunk by
    U(0, 0.3) of its width (half at each end), penalty U(0.5, 2), and the
    step-49 keypoint off on every odd lane."""
    rng = np.random.default_rng(F5_SEED)
    shrink = rng.uniform(0, 0.3, (batch, N)) * (PANDA_HI - PANDA_LO) / 2
    mask = np.zeros((batch, H))
    mask[:, 99] = 1.0
    mask[::2, 49] = 1.0
    ov = {"Rt": 10.0 ** rng.uniform(-6, -4, (batch, N)),
          "dt": dt * rng.uniform(0.8, 1.2, batch),
          "state_min": PANDA_LO + shrink, "state_max": PANDA_HI - shrink,
          "penalty": rng.uniform(0.5, 2.0, batch), "kp_mask": mask}
    return {k: ov[k] for k in (names or ov)}


def phase_overrides_f5(torch):
    """The recursive path's problem (B=4096, float32) through solve_batch
    with per-lane leaves: every leaf (a per-lane Rt and dt take the generic
    recursion `_backward_core`: riccati 0 launches), then the limit leaves
    and the keypoint mask alone (riccati once a backward sweep). Counts at
    0 just before each first solve, then 2 timed repeats; the share of
    lanes whose float32 solve ends in NaN at most 5% (the shrunk limits
    bind on most lanes). Then 64 lanes of each, of solve_batch_gn with
    per-lane Rt, dt and state_max, and of solve_batch_al on al_h400's
    problem (x5 <= 2, 12 iterations; dt U(0.8, 1.2) times its 0.01) with
    the same leaves, float64 card against CPU under the per-lane rule of
    phase 4. The AL solve ends in NaN on a few lanes, as the JAX package's
    float64 solve does on the same lanes; the card must give NaN on
    exactly the CPU's."""
    from ilqr_planner_torch.parallel import (solve_batch, solve_batch_al,
                                             solve_batch_gn)

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = recursive_batch(REC_B)
    outs = {}
    for label, names, riccati in (("all_leaves", None, False),
                                  ("limits_mask", F5_LIMIT_LEAVES, True)):
        ov = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
              for k, v in f5_overrides(REC_B, names).items()}
        res, counts, first_s, times, run = _drive(torch, spec, q0s, U0s,
                                                  NB_ITER, extra_ov=ov)
        sweeps = int(res.iterations.max())
        name = f"overrides_f5_{label}"
        cost = res.cost.double().cpu().numpy()
        out = {"phase": "end_to_end", "path": name, "nb_iter": NB_ITER,
               "leaves": sorted(ov),
               **_result_summary(res, REC_B, first_s, times, counts,
                                 ((REC_B, H, N), (REC_B, H - 1, N),
                                  (REC_B, H, 7))),
               "nan_lanes": int(np.isnan(cost).sum()),
               "median_cost_finite_lanes": float(np.nanmedian(cost)),
               "converged_frac": float(np.mean(cost < 1e-4)),
               "backward_sweeps": sweeps,
               "line_search_trials": counts["recursive_trials"]}
        emit(out)
        if not out["shapes_ok"] or out["nan_lanes"] > F5_NAN_SHARE_GATE * REC_B:
            fail(f"{name}: wrong shapes, or {out['nan_lanes']} lanes NaN")
        want = sweeps if riccati else 0
        others = [k for k in KERNELS if counts[k] and k != "riccati"]
        if sweeps == 0 or counts["riccati"] != want or others or counts["trials"]:
            fail(f"{name}: riccati launched {counts['riccati']} times for "
                 f"{sweeps} sweeps (want {want}); other kernels {others}, "
                 f"{counts['trials']} fleet trials")
        outs[label] = (out, run)

    q64, U64 = recursive_batch(XCHECK_B)
    for label, names, kernels in (("all_leaves", None, ()),
                                  ("limits_mask", F5_LIMIT_LEAVES, ("riccati",))):
        ov = f5_overrides(XCHECK_B, names)
        _card_vs_cpu(torch, f"overrides_f5_{label}",
                     lambda s, x0s, U0s, ov=ov: solve_batch(
                         s, {"x0": x0s, **ov}, U0s, NB_ITER),
                     flagship_spec, q64, U64, kernels, True, leaves=sorted(ov))
    ov = f5_overrides(XCHECK_B, F5_SOLVER_LEAVES)
    _card_vs_cpu(torch, "overrides_f5_gn",
                 lambda s, x0s, u0s: solve_batch_gn(
                     s, GN_KP, {"x0": x0s, **ov}, u0s, GN_NB_ITER),
                 flagship_spec, q64, np.zeros((XCHECK_B, (H - 1) * N)), (),
                 True, leaves=sorted(ov))
    ov_al = f5_overrides(XCHECK_B, F5_SOLVER_LEAVES, dt=0.01)

    def al(s, x0s, U0s):
        cons, b = al_constraints(torch, s.dtype, s.device)
        return solve_batch_al(s, cons, b, {"x0": x0s, **ov_al}, U0s,
                              AL_XCHECK_ITERS, *AL_ARGS)

    q_al, U_al = al_batch(XCHECK_B)
    _card_vs_cpu(torch, "overrides_f5_al", al, al_spec, q_al, U_al, (), True,
                 nan_ok=True, leaves=sorted(ov_al), nb_iter=AL_XCHECK_ITERS)
    return outs


class _Collectives:
    """Counts the torch.distributed collectives called inside the block."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "broadcast", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        self.count, self._saved = 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name)
            self._saved[name] = fn

            def counted(*a, _fn=fn, **kw):
                self.count += 1
                return _fn(*a, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)




def _equal_fields(a, b):
    """Every field of two results bit for bit (None on both, or equal)."""
    import dataclasses

    import torch

    def same(x, y):
        if x is None or y is None:
            return x is y
        return bool(torch.equal(x, y))
    return all(same(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def phase_sharded(torch, flagship_run, recursive_run):
    """solve_batch_sharded at world size 1 (a one-rank mesh on the card):
    on the flagship (B=36864) bit for bit the flagship phase's solve_batch,
    segment_backward once a sweep, no collective; its recursive route on
    the recursive path (B=4096) bit for bit solve_batch(prefer_fleet=False),
    riccati once a sweep; solve_batch_chunked on the recursive path in
    chunks of 1024, each lane bit for bit the unchunked solve's, riccati
    the sum of the four chunks' sweeps, the peak memory beside the
    unchunked solve's. Counts at 0 just before each first solve, then 2
    timed repeats."""
    from ilqr_planner_torch.parallel import (make_mesh, solve_batch_chunked,
                                             solve_batch_sharded)

    mesh = make_mesh(device="cuda")
    spec = flagship_spec(torch, torch.float32, "cuda")
    outs = {}
    for label, batch_fn, batch, prefer, ref_run, kernel in (
            ("sharded_flagship", flagship_batch, B, True, flagship_run,
             "segment_backward"),
            ("sharded_recursive", recursive_batch, REC_B, False, recursive_run,
             "riccati")):
        q0s, U0s = batch_fn(batch)
        x0 = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
        U0 = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
        ov = {"q0": x0, "x0": x0}
        with _Collectives() as coll:
            res, counts, first_s, times = _timed_runs(
                torch, lambda: solve_batch_sharded(spec, ov, U0, NB_ITER,
                                                   mesh=mesh,
                                                   prefer_fleet=prefer))
        sweeps = int(res.iterations.max())
        out = {"phase": "end_to_end", "path": label, "nb_iter": NB_ITER,
               "mesh": mesh.shape,
               **_result_summary(res, batch, first_s, times, counts,
                                 ((batch, H, N), (batch, H - 1, N),
                                  (batch, H, 7))),
               "collectives": coll.count, "backward_sweeps": sweeps,
               "bit_for_bit_solve_batch": _equal_fields(res, ref_run())}
        emit(out)
        if not (out["bit_for_bit_solve_batch"] and out["finite"]
                and coll.count == 0):
            fail(f"{label}: not solve_batch bit for bit, non-finite, or "
                 f"{coll.count} collectives at world size 1")
        _gate_only(label, counts, sweeps, kernel)
        outs[label] = out

    q0s, U0s = recursive_batch(REC_B)
    x0 = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    U0 = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    ov = {"q0": x0, "x0": x0}

    def peak_of(fn):
        """fn() -> (its result, the peak memory it allocated, MiB)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        return got, (torch.cuda.max_memory_allocated() - base) / 2**20

    whole, peak_whole = peak_of(recursive_run)
    (res, counts, first_s, times), peak_chunked = peak_of(
        lambda: _timed_runs(torch, lambda: solve_batch_chunked(
            spec, ov, U0, NB_ITER, chunk=CHUNK)))
    chunk_sweeps = int(res.iterations.view(-1, CHUNK).max(1).values.sum())
    gap = ((res.cost - whole.cost).abs() / whole.cost.abs()).max()
    out = {"phase": "end_to_end", "path": "chunked_recursive", "chunk": CHUNK,
           "nb_iter": NB_ITER,
           **_result_summary(res, REC_B, first_s, times, counts,
                             ((REC_B, H, N), (REC_B, H - 1, N), (REC_B, H, 7))),
           "bit_for_bit_unchunked": _equal_fields(res, whole),
           "X_bit_for_bit": bool(torch.equal(res.X, whole.X)),
           "cost_max_rel_gap": float(gap),
           "same_iterations": bool(torch.equal(res.iterations, whole.iterations)),
           "chunk_sweeps": chunk_sweeps,
           "peak_working_mib": {"unchunked": peak_whole,
                                "chunked": peak_chunked},
           "unchunked_solves_per_s": outs["sharded_recursive"][
               "solves_per_s_median"]}
    emit(out)
    if not (out["bit_for_bit_unchunked"] and out["finite"]):
        fail("chunked_recursive: lanes differ from the unchunked solve's, or "
             "non-finite values")
    _gate_only("chunked_recursive", counts, chunk_sweeps, "riccati")
    outs["chunked_recursive"] = out
    return outs


def phase_spmd(torch):
    """solve_batch_sp at world size 1 on the batch_gn problem's first
    scenario (H=100, keypoints 49 and 99, 10 iterations, float64) against
    batch.solve on the card: u within 1e-9 of max |u|, cost rtol 1e-9, the
    same iterations; and fleet_step on a 1 x 1 mesh at B=4096 (float32),
    its costs bit for bit the fleet's (solve_batch), segment_backward once
    a sweep, no collective. 2 timed repeats each."""
    import dataclasses

    from ilqr_planner_torch.parallel import make_mesh, solve_batch
    from ilqr_planner_torch.parallel.spmd import fleet_step, solve_batch_sp
    from ilqr_planner_torch.solvers import batch as tbatch

    q0s, _ = flagship_batch(GN_B)
    spec = flagship_spec(torch, torch.float64, "cuda")
    spec = dataclasses.replace(spec, x0=torch.as_tensor(q0s[0], device="cuda"))
    u0 = torch.zeros((H - 1) * N, dtype=torch.float64, device="cuda")
    mesh_sp = make_mesh((1,), ("sp",), device="cuda")
    with _Collectives() as coll:
        sp, _, sp_first, sp_times = _timed_runs(
            torch, lambda: solve_batch_sp(spec, GN_KP, GN_NB_ITER, u0, mesh_sp))
    one, _, one_first, one_times = _timed_runs(
        torch, lambda: tbatch.solve(spec, GN_KP, GN_NB_ITER, u0))
    u_diff = float((sp.u - one.u).abs().max())
    u_max = float(one.u.abs().max())
    out_sp = {"phase": "spmd", "path": "solve_batch_sp", "dtype": "float64",
              "mesh": mesh_sp.shape, "nb_iter": GN_NB_ITER,
              "u_max_abs_diff": u_diff, "u_max_abs": u_max,
              "cost": float(sp.cost), "cost_batch_solve": float(one.cost),
              "cost_rel": abs(float(sp.cost) / float(one.cost) - 1),
              "iterations": int(sp.iterations),
              "iterations_batch_solve": int(one.iterations),
              "first_call_s": sp_first, "repeat_times_s": sp_times,
              "batch_solve_repeat_times_s": one_times,
              "collectives": coll.count}
    emit(out_sp)
    if not (u_diff <= 1e-9 * u_max and out_sp["cost_rel"] <= 1e-9
            and out_sp["iterations"] == out_sp["iterations_batch_solve"]
            and coll.count == 0):
        fail("solve_batch_sp: not batch.solve's result on the card")

    spec = flagship_spec(torch, torch.float32, "cuda")
    q0s, U0s = recursive_batch(REC_B)
    x0 = torch.as_tensor(q0s, dtype=torch.float32, device="cuda")
    U0 = torch.as_tensor(U0s, dtype=torch.float32, device="cuda")
    ov = {"q0": x0, "x0": x0}
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cuda")
    with _Collectives() as coll:
        step, counts, first_s, times = _timed_runs(
            torch, lambda: fleet_step(spec, ov, U0, GN_KP, NB_ITER, mesh))
    ref = solve_batch(spec, ov, U0, NB_ITER)
    sweeps = int(ref.iterations.max())
    costs, mean_cost, U_sp, bcost, bit = step
    out = {"phase": "spmd", "path": "fleet_step", "mesh": mesh.shape,
           "batch": REC_B, "dtype": "float32", "nb_iter": NB_ITER,
           "first_call_s": first_s, "repeat_times_s": times,
           "steps_per_s_median": 1.0 / statistics.median(times),
           "costs_bit_for_bit_fleet": bool(torch.equal(costs, ref.cost)),
           "mean_cost": float(mean_cost),
           "mean_cost_rel": abs(float(mean_cost) / float(ref.cost.mean()) - 1),
           "batch_cost": float(bcost), "batch_iterations": int(bit),
           "U_sp_finite": bool(U_sp.isfinite().all()),
           "launches": counts, "backward_sweeps": sweeps,
           "collectives": coll.count}
    emit(out)
    if not (out["costs_bit_for_bit_fleet"] and out["mean_cost_rel"] <= 1e-6
            and coll.count == 0):
        fail("fleet_step: costs not the fleet's, or a collective at 1 x 1")
    _gate_only("fleet_step", counts, sweeps)
    return {"solve_batch_sp": out_sp, "fleet_step": out}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, REPO)
    import ilqr_planner_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(LINES), exist_ok=True)
    open(LINES, "w").close()
    t_start = time.time()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_s[name] = phase_s.get(name, 0.0) + time.time() - t0
        return out

    timed("build", phase_device_and_build)
    timed("calibration", phase_calibration, torch, "after_build")
    kv = timed("kernels_vs_twins", phase_kernels_vs_twins, torch)
    kv.update(timed("kernels_vs_twins", phase_slice_kernels, torch))
    kv.update(timed("kernels_vs_twins", phase_al_kernel, torch))
    kv.update(timed("kernels_vs_twins", phase_limit_penalty, torch))
    e2e = {}
    out_ov, run_ov, ov = timed("flagship_ov", phase_flagship_ov, torch)
    e2e["flagship_ov"] = (out_ov, run_ov)
    timed("staged", phase_staged, torch, ov)
    del ov
    torch.cuda.empty_cache()
    e2e["sequential_h600"] = timed("sequential_h600", phase_sequential, torch)
    e2e["planar2d"] = timed("planar2d", phase_planar, torch)
    for path in ("sequential_h600", "hybrid_h500", "planar2d"):
        e2e[f"{path}_recursive"] = timed(f"{path}_recursive",
                                         phase_recursive_slice, torch, path)
    timed("slice_cross_checks", phase_slice_cross_checks, torch)
    timed("slice_cross_checks", phase_record_recursive, torch)
    e2e["al_h400"] = timed("al_h400", phase_al_h400, torch)
    e2e["timeopt2nd"] = timed("timeopt2nd", phase_timeopt2nd, torch)
    timed("al_time2_cross_checks", phase_al_cross_checks, torch)
    timed("generic_sweep", phase_generic_sweep_launches, torch)
    e2e["flagship"] = timed("flagship", phase_flagship, torch)
    e2e["recursive"] = timed("recursive", phase_recursive, torch)
    for path in PATHS:
        e2e[path] = timed(path, phase_new_path, torch, path)
    for path in ("flagship", "recursive", *PATHS):
        timed("cross_checks", phase_cross_check, torch, path)
    timed("cross_checks", phase_joint_cross_check, torch)
    timed("cross_checks", phase_chain6_cross_check, torch)
    timed("dense_vs_sparse", phase_dense_vs_sparse, torch)
    timed("riccati_rounding", phase_riccati_rounding, torch)
    profiled = {}   # path -> {kernel: device ms a launch in its window}
    for path in ("flagship", "recursive", *PATHS, "flagship_ov",
                 "sequential_h600", "al_h400"):
        ours = timed("profiles", profile_window, torch, path, e2e[path][1])
        profiled[path] = {KERNEL_FUNCTIONS[fn]: ms for fn, (ms, _) in ours.items()}
    # the batch solver, LQT and pscan: no hand-written kernel on these paths
    for name in GN_ROWS:
        timed(name, phase_batch_gn, torch, name)
    timed("gn_cross_checks", phase_gn_cross_checks, torch)
    timed("lqt_h400", phase_lqt, torch)
    timed("pscan", phase_pscan, torch)
    # per-lane overrides of every leaf, the sharded, chunked and spmd solves
    f5 = timed("overrides_f5", phase_overrides_f5, torch)
    sh = timed("sharded", phase_sharded, torch, e2e["flagship"][1],
               e2e["recursive"][1])
    sp = timed("spmd", phase_spmd, torch)
    # the PyLQR drop-in API, float64, and riccati at its batch of one
    kv_b1, pylqr_launches = timed("pylqr", phase_pylqr, torch)
    timed("calibration", phase_calibration, torch, "end")

    def row(name, src, replaces, k, launches, path, **extra):
        return {"name": name, "route": "cuda",
                "source": f"ilqr_planner_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs_err_f64"],
                "max_abs_err_f32": k["max_abs_err_f32"],
                "ms": k["kernel_ms_f32"], "plain_ms": k["twin_ms_f32"],
                "ms_f64": k["kernel_ms_f64"], "plain_ms_f64": k["twin_ms_f64"],
                "bound_ms": k["bound_ms_f32"], "bound_by": k["bound_by"],
                "library_ms": None,
                "profiled_device_ms": profiled.get(path, {}).get(name),
                "launch": k.get("launch"), "shapes": k["shapes"], **extra,
                **{key: k[f"kernel_{key}"] for key in
                   ("ms_one_launch_f32", "ms_one_launch_f64")
                   if f"kernel_{key}" in k}}

    pallas = "ilqr_planner_tpu/ops/pallas_kernels/"
    sb_src = pallas + "segment_backward.py:339"
    ric_src = pallas + "riccati.py:258"
    lp_src = ("none: XLA fuses the JAX package's jnp penalty "
              "(ilqr_planner_tpu/solvers/fleet.py _limit_arrays, _limit_cost_full)")
    riccati_row = row(
        "riccati", "riccati.cu", ric_src, kv["riccati"],
        e2e["recursive"][0]["launches"]["riccati"], "recursive", width="7x6",
        launches_overrides_f5_limits_mask=f5["limits_mask"][0]["launches"]["riccati"],
        launches_overrides_f5_all_leaves=f5["all_leaves"][0]["launches"]["riccati"],
        launches_sharded_recursive=sh["sharded_recursive"]["launches"]["riccati"],
        launches_chunked=sh["chunked_recursive"]["launches"]["riccati"])
    for key in ("riccati_dense", f"riccati_b{B}", f"riccati_dense_b{B}"):
        tag = key.removeprefix("riccati_")
        riccati_row.update({f"ms_{tag}": kv[key]["kernel_ms_f32"],
                            f"ms_f64_{tag}": kv[key]["kernel_ms_f64"],
                            f"plain_ms_{tag}": kv[key]["twin_ms_f32"],
                            f"bound_ms_{tag}": kv[key]["bound_ms_f32"],
                            f"max_abs_err_{tag}": kv[key]["max_abs_err_f64"]})
    ov_launches = e2e["flagship_ov"][0]["launches"]["segment_backward"]
    emit({"kernels": [
        row("segment_backward", "segment_backward.cu", sb_src,
            kv["segment_backward"],
            e2e["flagship"][0]["launches"]["segment_backward"], "flagship",
            width="n=7 H=100", launches_flagship_ov=ov_launches,
            launches_sharded=sh["sharded_flagship"]["launches"]["segment_backward"],
            launches_fleet_step=sp["fleet_step"]["launches"]["segment_backward"],
            profiled_device_ms_flagship_ov=profiled["flagship_ov"].get(
                "segment_backward")),
        row("segment_backward", "segment_backward.cu", sb_src,
            kv["segment_backward H600"],
            e2e["sequential_h600"][0]["launches"]["segment_backward"],
            "sequential_h600", width="n=7 H=600 (sequential_h600)"),
        row("segment_backward", "segment_backward.cu", sb_src,
            kv["segment_backward n3"],
            e2e["planar2d"][0]["launches"]["segment_backward"], "planar2d",
            width="n=3 H=100 (planar2d)"),
        row("segment_backward", "segment_backward.cu", sb_src,
            kv["segment_backward H400"],
            e2e["al_h400"][0]["launches"]["segment_backward"], "al_h400",
            width="n=7 H=400 B=8192 (al_h400, the bound folded)"),
        row("segment_backward_2nd", "segment_backward_2nd.cu",
            pallas + "segment_backward_2nd.py:255", kv["second"],
            e2e["posorn2nd"][0]["launches"]["segment_backward_2nd"], "posorn2nd"),
        row("segment_backward_time1", "segment_backward_2nd.cu",
            pallas + "segment_backward_2nd.py:270", kv["time1"],
            e2e["timeopt"][0]["launches"]["segment_backward_time1"], "timeopt"),
        row("rollout_time1", "rollout_time1.cu", pallas + "rollout_time1.py:169",
            kv["rollout_time1"], e2e["timeopt"][0]["launches"]["rollout_time1"],
            "timeopt"),
        riccati_row,
        *[row("riccati", "riccati.cu", ric_src, kv[f"riccati {w}"],
              e2e[path][0]["launches"]["riccati"], path,
              width=f"{w} ({path})")
          for w, path in (("7x12", "sequential_h600_recursive"),
                          ("7x13", "hybrid_h500_recursive"),
                          ("3x2", "planar2d_recursive"))],
        row("riccati", "riccati.cu", ric_src, kv_b1, pylqr_launches, "pylqr",
            width="7x6 B=1 (pylqr POS_ORN_SYS, float64 solve)"),
        *[row(f"limit_penalty_{form.split('_')[0]}", "limit_penalty.cu",
              lp_src, kv[f"limit_penalty {cell} {form}"],
              e2e[path][0]["launches"][f"limit_penalty_{form.split('_')[0]}"],
              path, width=f"{form} {cell}_h100.bulk shape")
          for cell, path in (("posorn", "flagship"), ("timeopt", "timeopt"))
          for form in ("cost_affine", "cost", "arrays")
          if f"limit_penalty {cell} {form}" in kv]],
        "phase_s": phase_s, "total_s": time.time() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
