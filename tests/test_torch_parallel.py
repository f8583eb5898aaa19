"""Port parity, the rest of `parallel/`: `make_mesh`, `distributed`,
`solve_batch_chunked`, `solve_batch_sharded`, `spmd.solve_batch_sp` and
`spmd.fleet_step`, float64 on the CPU; and the package surface.

At one rank the port is held against the JAX package on its 8 virtual CPU
devices (tests/conftest.py): sp u atol 1e-9, cost rtol 1e-9 (the JAX
package's own, tests/test_parallel.py); the sharded and chunked solves at
the port-vs-JAX tolerance of their routes (iterations and alpha equal,
cost rtol 1e-10, U atol 1e-9; the JAX package's sharded-vs-single fleet
rtol 1e-12 holds the port's sharded solve against its own `solve_batch`,
bit for bit here).

Several ranks are `gloo` processes that this file starts on itself
(`python tests/test_torch_parallel.py --worker <case> <rank> <world>
<store> <out>`, one thread each, never importing JAX), meeting at
`file://<tmp>/store`: 2 ranks of `solve_batch_sharded`, 3 of
`solve_batch_sp`, 6 of `fleet_step` on a (2, 3) mesh. Every rank returns
the same result, held against the one-rank port: the sharded lanes bit for
bit the one-rank solve of each rank's lanes (the lane-major fleet rounds
by batch size on the CPU, so a 2-lane solve is not bit for bit lanes of a
4-lane one; the recursive route is, and is held against the whole batch
too), sp within u atol 1e-9 and cost rtol 1e-9. Each worker has its own
deadline; on expiry every worker is killed.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_overrides import Q0, _keypoints
from test_torch_sequential import CMD, QD, T1, frames

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.parallel import (distributed, make_mesh, mesh,
                                         solve_batch, solve_batch_chunked,
                                         solve_batch_sharded)
from ilqr_planner_torch.parallel.spmd import fleet_step, solve_batch_sp
from ilqr_planner_torch.solvers import batch
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec, sequential_spec

H, B = 31, 4                     # H - 1 = 30: a multiple of 2, 3 and 6
KP = (H // 2 - 1, H - 1)
REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 300


def port_spec():
    """The port's half of tests/test_torch_overrides.py::_specs(H=31)."""
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    qmax = np.ones(7) * np.pi * 10
    return make_spec("posorn", robot, _keypoints("posorn", 1, H, kps_mod),
                     np.ones(7) * 1e-5, H, 1, dt=0.1, q0=Q0, q_max=qmax,
                     q_min=-qmax, device="cpu")


def port_seq_spec():
    """The port's half of tests/test_torch_f5.py::_seq_jspec(31)."""
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0",
                                             "panda_tip", device="cpu"))
    lim = dict(q_max=Q0 + 0.35, q_min=Q0 - 0.35, device="cpu")
    sub1 = make_spec("posorn", robot.with_frame(frames()[0]),
                     [kps_mod.PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], QD,
                                             H // 2)],
                     CMD, H, 1, dt=0.05, q0=Q0, **lim)
    sub2 = make_spec("posorn", robot, [kps_mod.PosOrnKeypoint(*T1, QD, H - 1)],
                     CMD, H, 1, dt=0.05, q0=Q0, **lim)
    return sequential_spec((sub1, sub2), CMD)


def lanes(seq_mu=None, seed=0):
    """(x0s [B, 7], U0s [B, H-1, 7], per-lane Rt [B, 7], the second
    subsystem's targets per lane [B, H, 7] from `seq_mu` [H, 7])."""
    rng = np.random.default_rng(seed)
    x0s = Q0[None] + 0.05 * rng.normal(size=(B, 7))
    Rt = 10.0 ** rng.uniform(-6, -4, (B, 7))
    mu2 = None
    if seq_mu is not None:
        mu2 = np.repeat(np.asarray(seq_mu)[None], B, axis=0)
        mu2[:, H - 1, :3] += 0.04 * rng.normal(size=(B, 3))
    return x0s, np.zeros((B, H - 1, 7)), Rt, mu2


def _fields(res, names=("U", "cost", "iterations")):
    return {k: getattr(res, k) for k in names}


# ---------------------------------------------------------------------------
# worker ranks
# ---------------------------------------------------------------------------

def _case_sharded(m):
    """Three sharded solves over 'dp': the fleet (x0 per lane), the
    recursive route (a per-lane Rt) and a sequential spec's list
    override through the fleet."""
    spec, seq = port_spec(), port_seq_spec()
    x0s, U0s, Rt, mu2 = lanes(seq.subs[1].mu)
    out = {}
    for name, s, ov in (("fleet", spec, {"x0": x0s}),
                        ("recursive", spec, {"x0": x0s, "Rt": Rt}),
                        ("sequential", seq, {"x0": x0s, "mu": [None, mu2]})):
        res = solve_batch_sharded(s, ov, U0s, 4, mesh=m)
        out.update({f"{name}.{k}": v for k, v in _fields(res).items()})
    return out


def _case_sp(m):
    res = solve_batch_sp(port_spec(), KP, 10, np.zeros((H - 1) * 7), m)
    return {"u": res.u, "cost": res.cost, "iterations": res.iterations}


def _case_fleet_step(m):
    x0s, U0s, _, _ = lanes()
    out = fleet_step(port_spec(), {"x0": x0s}, U0s, KP, 5, m)
    return dict(zip(("costs", "mean_cost", "U_sp", "batch_cost",
                     "batch_iterations"), out))


WORKER_CASES = {"sharded": (_case_sharded, (2,), ("dp",)),
                "sp": (_case_sp, (3,), ("sp",)),
                "fleet_step": (_case_fleet_step, (2, 3), ("dp", "sp"))}


def _worker(case, rank, world, store, out):
    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", int(world), int(rank),
                           device="cpu")
    fn, shape, names = WORKER_CASES[case]
    result = fn(make_mesh(shape, names, device="cpu"))
    torch.save(result, Path(out) / f"{case}_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _launch(case, tmp_path):
    """Run the case's ranks as processes; -> every rank's result."""
    world = int(np.prod(WORKER_CASES[case][1]))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", case, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{case}: the {world} ranks did not finish in {DEADLINE_S} s")
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r}:\n{err.decode()[-4000:]}"
    return [torch.load(tmp_path / f"{case}_{r}.pt") for r in range(world)]


def _same_on_every_rank(results):
    for other in results[1:]:
        for k, v in results[0].items():
            assert torch.equal(v, other[k]), k


# ---------------------------------------------------------------------------
# several ranks (gloo)
# ---------------------------------------------------------------------------

def test_sharded_on_two_ranks_matches_one_rank(tmp_path):
    """Each rank returns the whole batch; each rank's lanes are bit for bit
    the one-rank solve of those lanes, and the recursive route's also
    the whole batch's."""
    results = _launch("sharded", tmp_path)
    _same_on_every_rank(results)
    spec, seq = port_spec(), port_seq_spec()
    x0s, U0s, Rt, mu2 = lanes(seq.subs[1].mu)
    cases = {"fleet": (spec, {"x0": x0s}),
             "recursive": (spec, {"x0": x0s, "Rt": Rt}),
             "sequential": (seq, {"x0": x0s, "mu": [None, mu2]})}
    for name, (s, ov) in cases.items():
        halves = [solve_batch(s, mesh._gather(ov, torch.arange(lo, lo + 2)),
                              U0s[lo:lo + 2], 4) for lo in (0, 2)]
        for k in ("U", "cost", "iterations"):
            want = torch.cat([getattr(h, k) for h in halves])
            assert torch.equal(results[0][f"{name}.{k}"], want), (name, k)
    whole = solve_batch(spec, cases["recursive"][1], U0s, 4)
    assert torch.equal(results[1]["recursive.U"], whole.U)


def test_sp_on_three_ranks_matches_one_rank(tmp_path):
    """solve_batch_sp over 3 ranks (10 control steps each) against the
    one-rank solve and batch.solve."""
    results = _launch("sp", tmp_path)
    _same_on_every_rank(results)
    spec = port_spec()
    u0 = np.zeros((H - 1) * 7)
    for ref in (solve_batch_sp(spec, KP, 10, u0, make_mesh((1,), ("sp",),
                                                          device="cpu")),
                batch.solve(spec, KP, 10, u0)):
        np.testing.assert_allclose(results[0]["u"].numpy(), ref.u.numpy(),
                                   atol=1e-9, rtol=0)
        np.testing.assert_allclose(results[0]["cost"].item(), ref.cost.item(),
                                   rtol=1e-9)
        assert int(results[0]["iterations"]) == int(ref.iterations)


def test_fleet_step_on_a_two_by_three_mesh_matches_one_rank(tmp_path):
    """fleet_step on 6 ranks, (dp, sp) = (2, 3): the costs are the fleet's
    of each dp shard's lanes, bit for bit; the mean cost the mean of the
    shards' means; U_sp and the iterations dp shard 0's scenario 0 solved
    by solve_batch_sp; the batch cost the mean over the two shards'
    scenario 0."""
    results = _launch("fleet_step", tmp_path)
    _same_on_every_rank(results)
    got = results[0]
    spec = port_spec()
    x0s, U0s, _, _ = lanes()
    halves = [solve_batch(spec, {"x0": x0s[lo:lo + 2]}, U0s[lo:lo + 2], 5)
              for lo in (0, 2)]
    assert torch.equal(got["costs"], torch.cat([h.cost for h in halves]))
    np.testing.assert_allclose(got["mean_cost"].item(), np.mean(
        [h.cost.mean().item() for h in halves]), rtol=1e-12)
    one = make_mesh((1,), ("sp",), device="cpu")
    firsts = [solve_batch_sp(dataclasses.replace(spec, x0=torch.as_tensor(x0s[lo])),
                             KP, 5, U0s[lo].reshape(-1), one) for lo in (0, 2)]
    np.testing.assert_allclose(got["U_sp"].reshape(-1).numpy(),
                               firsts[0].u.numpy(), atol=1e-9, rtol=0)
    assert int(got["batch_iterations"]) == int(firsts[0].iterations)
    np.testing.assert_allclose(got["batch_cost"].item(), np.mean(
        [f.cost.item() for f in firsts]), rtol=1e-9)


# ---------------------------------------------------------------------------
# one rank, against the JAX package on its 8 virtual devices
# ---------------------------------------------------------------------------

def _jax_mesh(shape, names):
    import jax

    from ilqr_planner_tpu.parallel import make_mesh as jmake_mesh

    n = int(np.prod(shape))
    return jmake_mesh(shape, names, devices=np.array(jax.devices()[:n]))


def test_make_mesh_and_distributed_at_one_rank(monkeypatch):
    """Without a coordinator `initialize` is a no-op (idempotent, no
    process group) and `make_mesh` a one-rank mesh whose collectives are
    the identity; a shape that is not the world raises; a coordinator with
    no card raises rather than falling back to gloo."""
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)
    distributed.initialize()
    distributed.initialize()
    assert distributed.is_initialized() and not dist.is_initialized()
    assert distributed.process_summary() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    m = make_mesh(device="cpu")
    assert m.shape == {"dp": 1} and m.index("dp") == 0
    t = torch.arange(3.0)
    assert m.all_reduce(t, "dp") is t and m.all_gather(t, "dp") is t
    m2 = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    assert m2.shape == {"dp": 1, "sp": 1}
    with pytest.raises(ValueError, match="the world has 1"):
        make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((1, 1), ("dp",), device="cpu")
    if not torch.cuda.is_available():
        monkeypatch.setattr(distributed, "_initialized", False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("localhost:29999", 2, 0)
        assert not dist.is_initialized()


def test_make_mesh_devices_at_one_rank():
    """`devices=`, one device a rank: at one rank the mesh of
    make_mesh(device="cpu"), as the JAX make_mesh over one device; a list
    that is not the world size, or `device` beside it, raises."""
    import jax

    from ilqr_planner_tpu.parallel import make_mesh as jmake_mesh

    for shape, names in ((None, ("dp",)), ((1, 1), ("dp", "sp"))):
        got = make_mesh(shape, names, devices=["cpu"])
        assert got == make_mesh(shape, names, device="cpu")
        ref = jmake_mesh(shape, names, devices=np.array(jax.devices()[:1]))
        assert got.shape == dict(ref.shape)
    assert make_mesh(devices=[torch.device("cpu")]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="got 2 devices; the world has 1"):
        make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="either device or devices"):
        make_mesh(device="cpu", devices=["cpu"])


def test_size_errors():
    """B not a multiple of the chunk or of the shard axis, H-1 not a
    multiple of the sp axis, and a time-optimal spec in solve_batch_sp
    raise ValueError, as in the JAX package."""
    spec = port_spec()
    x0s, U0s, _, _ = lanes()
    with pytest.raises(ValueError, match="multiple of chunk 3"):
        solve_batch_chunked(spec, {"x0": x0s}, U0s, 2, chunk=3)
    three = mesh.Mesh(("dp",), (3,), torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the 'dp' axis size 3"):
        solve_batch_sharded(spec, {"x0": x0s}, U0s, 2, mesh=three)
    four = mesh.Mesh(("sp",), (4,), torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the sp axis size 4"):
        solve_batch_sp(spec, KP, 2, np.zeros((H - 1) * 7), four)
    with pytest.raises(ValueError, match="must divide the sp axis size 4"):
        fleet_step(spec, {"x0": x0s}, U0s, KP, 2,
                   mesh.Mesh(("dp", "sp"), (1, 4), torch.device("cpu")))
    robot = spec.robot
    timed = make_spec("posorn_time", robot, [], np.ones(8) * 1e-5, H, 1,
                      device="cpu")
    with pytest.raises(ValueError, match="closed-form"):
        solve_batch_sp(timed, (H - 1,), 2, np.zeros((H - 1) * 8),
                       make_mesh((1,), ("sp",), device="cpu"))


@pytest.fixture(scope="module")
def jax_problems():
    from test_torch_f5 import _seq_jspec
    from test_torch_overrides import _specs

    from ilqr_planner_torch.utils.convert import spec_like

    jspec, spec = _specs(H=H)
    jseq = _seq_jspec(H)
    return jspec, spec, jseq, spec_like(jseq, device="cpu")


def _assert_route(got, ref):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=1e-9,
                               rtol=0)


def test_sharded_at_one_rank_matches_jax(jax_problems):
    """solve_batch_sharded at one rank: the fleet, the recursive route (a
    per-lane Rt) and a sequential spec's list override, against the JAX
    package's sharded solve over its 8 devices (B = 8), and bit for bit
    the port's solve_batch."""
    from ilqr_planner_tpu.parallel import solve_batch_sharded as jsharded

    jspec, spec, jseq, seq = jax_problems
    rng = np.random.default_rng(3)
    x0s = Q0[None] + 0.05 * rng.normal(size=(8, 7))
    U0s = np.zeros((8, H - 1, 7))
    mu2 = np.repeat(np.asarray(jseq.subs[1].mu)[None], 8, axis=0)
    mu2[:, H - 1, :3] += 0.04 * rng.normal(size=(8, 3))
    cases = ((jspec, spec, {"x0": x0s}),
             (jspec, spec, {"x0": x0s, "Rt": 10.0 ** rng.uniform(-6, -4, (8, 7))}),
             (jseq, seq, {"x0": x0s, "mu": [None, mu2]}))
    jm = _jax_mesh((8,), ("dp",))
    for js, s, ov in cases:
        ref = jsharded(js, ov, U0s, 4, mesh=jm)
        got = solve_batch_sharded(s, ov, U0s, 4)      # the default mesh
        _assert_route(got, ref)
        plain = solve_batch(s, ov, U0s, 4)
        for k in ("X", "U", "cost", "iterations", "alpha", "Ks", "ds"):
            assert torch.equal(getattr(got, k), getattr(plain, k)), k


def test_chunked_matches_jax_and_unchunked(jax_problems):
    """solve_batch_chunked (B = 8 in chunks of 4) against the JAX package's
    and, lane by lane bit for bit, the unchunked recursive solve; a
    sequential spec's list override is chunked entry by entry, where the
    JAX function fails (it reads the list-valued leaf off the top-level
    spec), and its lanes equal the unchunked ones."""
    from ilqr_planner_tpu.parallel import solve_batch_chunked as jchunked

    jspec, spec, _, seq = jax_problems
    rng = np.random.default_rng(4)
    x0s = Q0[None] + 0.05 * rng.normal(size=(8, 7))
    U0s = np.zeros((8, H - 1, 7))
    ov = {"x0": x0s, "dt": rng.uniform(0.08, 0.12, 8)}
    got = solve_batch_chunked(spec, ov, U0s, 4, chunk=4)
    _assert_route(got, jchunked(jspec, ov, U0s, 4, chunk=4))
    whole = solve_batch(spec, ov, U0s, 4, prefer_fleet=False)
    for k in ("X", "U", "cost", "iterations", "Ks", "ds"):
        assert torch.equal(getattr(got, k), getattr(whole, k)), k
    mu2 = np.repeat(seq.subs[1].mu.numpy()[None], 8, axis=0)
    mu2[:, H - 1, :3] += 0.04 * rng.normal(size=(8, 3))
    ov = {"x0": x0s, "mu": [None, mu2]}
    got = solve_batch_chunked(seq, ov, U0s, 4, chunk=4)
    whole = solve_batch(seq, ov, U0s, 4, prefer_fleet=False)
    assert torch.equal(got.U, whole.U) and torch.equal(got.cost, whole.cost)


def test_sp_and_fleet_step_at_one_rank_match_jax(jax_problems):
    """solve_batch_sp at one rank against the JAX package's over 3
    devices and batch.solve (u atol 1e-9, cost rtol 1e-9, iterations
    equal); fleet_step on a (1, 1) mesh against the JAX package's on
    (1, 3): costs at the fleet tolerance, U_sp, the batch cost and its
    iterations."""
    from ilqr_planner_tpu.parallel.spmd import fleet_step as jfleet_step
    from ilqr_planner_tpu.parallel.spmd import solve_batch_sp as jsp

    jspec, spec, _, _ = jax_problems
    u0 = np.zeros((H - 1) * 7)
    got = solve_batch_sp(spec, KP, 10, u0, make_mesh((1,), ("sp",), device="cpu"))
    for ref in (jsp(jspec, KP, 10, u0, _jax_mesh((3,), ("sp",))),
                batch.solve(spec, KP, 10, u0)):
        np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-9)
        assert int(got.iterations) == int(ref.iterations)
    x0s, U0s, _, _ = lanes(seed=5)
    out = fleet_step(spec, {"x0": x0s}, U0s, KP, 5,
                     make_mesh((1, 1), ("dp", "sp"), device="cpu"))
    ref = jfleet_step(jspec, {"x0": x0s}, U0s, KP, 5,
                      _jax_mesh((1, 3), ("dp", "sp")))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-10)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-10)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-9)
    assert int(out[4]) == int(ref[4])


# parameters of the JAX package's public callables that the port does not
# take, each with its reason
EXEMPT_PARAMETERS = {
    "unroll": "lax.scan's unroll factor, which exists only under XLA",
}


def test_package_surface_matches_jax():
    """`import ilqr_planner_torch` exposes the JAX package's subpackages,
    compat and __version__; every JAX module has its port counterpart,
    every public name of it is there, and every parameter of every public
    callable is a parameter of the port's, but those in EXEMPT_PARAMETERS.
    The Pallas kernels' modules have CUDA counterparts of other names
    (`ops/cuda_kernels`)."""
    import importlib
    import inspect
    import pkgutil

    import ilqr_planner_tpu

    import ilqr_planner_torch

    for name in ("models", "ops", "parallel", "solvers", "systems", "utils",
                 "compat", "__version__"):
        assert hasattr(ilqr_planner_torch, name), name
    missing, absent, params = [], [], []
    for info in pkgutil.walk_packages(ilqr_planner_tpu.__path__,
                                      "ilqr_planner_tpu."):
        if info.name.startswith("ilqr_planner_tpu.ops.pallas_kernels"):
            continue
        jmod = importlib.import_module(info.name)
        try:
            tmod = importlib.import_module(
                info.name.replace("ilqr_planner_tpu", "ilqr_planner_torch"))
        except ImportError:
            absent.append(info.name.split(".", 1)[1])
            continue
        names = getattr(jmod, "__all__", None) or [
            n for n, v in vars(jmod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", jmod.__name__) in (jmod.__name__, None)]
        missing += [f"{info.name}.{n}" for n in names if not hasattr(tmod, n)]
        for n in names:
            jv, tv = getattr(jmod, n), getattr(tmod, n, None)
            if tv is None or not callable(jv):
                continue
            theirs = inspect.signature(tv).parameters
            params += [f"{info.name}.{n}({p}=)"
                       for p in inspect.signature(jv).parameters
                       if p not in theirs and p not in EXEMPT_PARAMETERS]
    assert missing == []
    assert absent == []
    assert params == []


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(*sys.argv[2:])
