"""Port parity, per-scenario overrides of every Spec leaf: `Rt`, `dt`,
`state_min`, `state_max`, `limit_weight`, `penalty` and `kp_mask` with a
leading scenario axis, on a plain spec and on a sequential one (a list with
one entry a subsystem, None keeping that subsystem's leaf; `Rt` also as the
top level's array), one leaf at a time through `solve_batch` (both
`prefer_fleet`: these leaves take the recursive route) against the JAX
package's vmap over the same leaf, float64 on the CPU (where the riccati
kernel's wrapper runs its twin). The other batch entry points are in
tests/test_torch_f5_solvers.py.

Tolerances: iterations and alpha equal per lane, cost rtol 1e-10, U atol
1e-9.
"""

import numpy as np
import pytest
import torch
from test_torch_overrides import Q0, _specs
from test_torch_sequential import CMD, QD, T1, frames, jax_robot

from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.solvers import ilqr
from ilqr_planner_torch.utils.convert import spec_like

H, B = 20, 3
KP = (H // 2 - 1, H - 1)                       # the plain spec's keypoints
LEAVES = ("Rt", "dt", "state_min", "state_max", "limit_weight", "penalty",
          "kp_mask")
BOX = 0.35                                     # limits Q0 +- BOX, binding


def _bind(jspec, box=BOX):
    """A JAX spec with its joint limits at Q0 +- box (the trajectories
    cross them)."""
    return jspec.replace(state_max=np.asarray(Q0 + box),
                         state_min=np.asarray(Q0 - box))


def _lanes(sub, name, seed):
    """Leaf `name` of the JAX (sub)spec `sub` per lane, made from a seed:
    lane 0 keeps the spec's value, lanes 1 and 2 take their own: Rt
    log-uniform in [1e-6, 1e-4], dt U(0.08, 0.12), the box shrunk by
    U(0, 0.3) of its width, limit weights 0 or 1, penalty U(0.5, 4), the
    keypoint mask with the first keypoint off on lane 1."""
    rng = np.random.default_rng(seed)
    base = np.asarray(getattr(sub, name))
    out = np.repeat(base[None], B, axis=0)
    if name == "Rt":
        out[1:] = 10.0 ** rng.uniform(-6, -4, (B - 1,) + base.shape)
    elif name == "dt":
        out[1:] = rng.uniform(0.08, 0.12, B - 1)
    elif name in ("state_max", "state_min"):
        width = np.asarray(sub.state_max) - np.asarray(sub.state_min)
        sign = -1.0 if name == "state_max" else 1.0
        out[1:] += sign * rng.uniform(0, 0.3, (B - 1,) + base.shape) * width
    elif name == "limit_weight":
        out[1:] = rng.integers(0, 2, (B - 1,) + base.shape)
    elif name == "penalty":
        out[1:] = rng.uniform(0.5, 4.0, B - 1)
    else:                                          # kp_mask
        out[1, np.nonzero(base)[0][0]] = 0.0
    return out


def _seq_jspec(H=H):
    """Two subsystems of one robot (the object frame and the bare arm),
    keypoints at H/2 and H-1, limits Q0 +- 0.35 on both."""
    from ilqr_planner_tpu.systems.keypoints import PosOrnKeypoint
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec
    from ilqr_planner_tpu.systems.spec import sequential_spec as jseq

    robot = jax_robot()
    lim = dict(q_max=Q0 + BOX, q_min=Q0 - BOX, dtype=np.float64)
    sub1 = jmake_spec("posorn", robot.with_frame(frames()[0]),
                      [PosOrnKeypoint([0, 0, -0.15], [1, 0, 0, 0], QD, H // 2)],
                      CMD, H, 1, dt=0.05, q0=Q0, **lim)
    sub2 = jmake_spec("posorn", robot, [PosOrnKeypoint(*T1, QD, H - 1)],
                      CMD, H, 1, dt=0.05, q0=Q0, **lim)
    return jseq((sub1, sub2), CMD)


# the subsystem whose leaf a sequential case overrides per lane: sub 0's
# dt drives the dynamics, and its keypoint is the one with a control (the
# final cost takes u = 0); "Rt_top" is the top level's array
SEQ_SUB = {"Rt": 0, "dt": 0, "state_min": 1, "state_max": 0,
           "limit_weight": 0, "penalty": 1, "kp_mask": 0}


def _overrides(jspec, names, seed=5):
    """{leaf: per-lane values} for a plain spec, {leaf: [sub 0's or None,
    sub 1's or None]} for a sequential one (the top level's array for
    'Rt_top'), plus the per-lane initial state."""
    rng = np.random.default_rng(seed)
    x0s = Q0[None] + 0.03 * rng.normal(size=(B, 7))
    ov = {"x0": x0s}
    for i, name in enumerate(names):
        if jspec.kind != "sequential":
            ov[name] = _lanes(jspec, name, seed + i)
        elif name == "Rt_top":
            ov["Rt"] = _lanes(jspec, "Rt", seed + i)
        else:
            j = SEQ_SUB[name]
            entry = [None, None]
            entry[j] = _lanes(jspec.subs[j], name, seed + i)
            ov[name] = entry
    return ov


@pytest.fixture(scope="module")
def problems():
    """The plain H = 20 posorn problem (tests/test_torch_overrides.py) and
    the sequential one, with binding limits, in both packages."""
    jplain = _bind(_specs(H=H)[0])
    jseq = _seq_jspec()
    return {"plain": (jplain, spec_like(jplain, device="cpu")),
            "sequential": (jseq, spec_like(jseq, device="cpu"))}


def _assert_matches(got, ref, alpha=True):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    if alpha:
        np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=1e-9,
                               rtol=0)


def _count_riccati(monkeypatch):
    calls = []
    riccati = ilqr.riccati_backward
    monkeypatch.setattr(ilqr, "riccati_backward",
                        lambda *a: calls.append(1) or riccati(*a))
    return calls


CASES = ([("plain", n) for n in LEAVES]
         + [("sequential", n) for n in LEAVES + ("Rt_top",)])


@pytest.mark.parametrize("kind,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_solve_batch_lane_leaf_matches_jax(problems, kind, name, monkeypatch):
    """One leaf per lane through solve_batch on both routes (the fleet
    does not bind these leaves, so prefer_fleet=True takes the recursive
    route as the JAX package's does) against the JAX vmap route, 4
    iterations without early stop. Lane 0 keeps the spec's value and gives
    the spec's own solve. The riccati twin runs unless the top level's Rt
    or subsystem 0's dt carries the lane axis; the solves that change a
    lane differ from the spec's own there."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec = problems[kind]
    ov = _overrides(jspec, (name,))
    U0s = np.zeros((B, H - 1, 7))
    ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False, prefer_fleet=False)
    calls = _count_riccati(monkeypatch)
    for prefer in (True, False):
        got = solve_batch(spec, ov, U0s, 4, early_stop=False,
                          prefer_fleet=prefer)
        _assert_matches(got, ref)
    lane_gains = name in ("Rt_top", "dt") or (kind == "plain" and name == "Rt")
    assert bool(calls) == (not lane_gains)
    own = solve_batch(spec, {"x0": ov["x0"]}, U0s, 4, early_stop=False)
    np.testing.assert_allclose(got.cost[0].item(), own.cost[0].item(),
                               rtol=1e-10)
    assert not np.allclose(got.cost[1:].numpy(), own.cost[1:].numpy(),
                           rtol=1e-6, atol=0)


def test_riccati_route_equals_backward_core_with_lane_limits_and_mask(problems):
    """The twin route the recursive solver keeps for per-lane limits and
    keypoint masks (limit terms [B, H, nx], the masked residual, a shared
    precision) gives `_backward_core`'s gains on such a batch."""
    from ilqr_planner_torch.parallel.mesh import batch_specs

    jspec, spec = problems["plain"]
    ov = _overrides(jspec, ("state_max", "state_min", "limit_weight",
                            "penalty", "kp_mask"))
    spec_b = batch_specs(spec, ov)
    assert ilqr._riccati_route(spec_b)
    x0s = torch.as_tensor(ov["x0"])
    U0s = 0.05 * torch.sin(torch.arange(B * (H - 1) * 7, dtype=torch.float64)
                           ).reshape(B, H - 1, 7)
    X, fX, U, As, Bs, Js, _, _ = ilqr.rollout(spec_b, 0.0, torch.zeros(
        B, H - 1, 7, 7, dtype=torch.float64), torch.zeros_like(U0s),
        torch.zeros(B, H, 7, dtype=torch.float64), U0s, x0s)
    Ks, ds = ilqr._backward(spec_b, X, fX, U, As, Bs, Js)
    Kc, dc = ilqr._backward_core(spec_b, As, Bs,
                                 *ilqr._stage_terms(spec_b, X, fX, U, Js))
    for got, want in ((Ks, Kc), (ds, dc)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * float(want.abs().max()))


def test_kp_mask_off_on_every_lane_matches_jax(problems, monkeypatch):
    """A keypoint masked off on every lane leaves the union of keypoint
    steps, where the JAX package quadratizes: its precision is zeroed
    there, and the riccati twin stays on the route."""
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec = problems["plain"]
    mask = np.repeat(np.asarray(jspec.kp_mask)[None], B, axis=0)
    mask[:, KP[0]] = 0.0
    ov = {"x0": _overrides(jspec, ())["x0"], "kp_mask": mask}
    U0s = np.zeros((B, H - 1, 7))
    ref = jsolve_batch(jspec, ov, U0s, 4, early_stop=False, prefer_fleet=False)
    calls = _count_riccati(monkeypatch)
    _assert_matches(solve_batch(spec, ov, U0s, 4, early_stop=False), ref)
    assert calls


def test_lane_leaf_errors(problems):
    """A leaf of the wrong shape, an unknown name and 'dq0' (no solver
    reads it: the initial state is 'x0') raise; a sequential spec takes
    an array for the top level's Rt only."""
    _, spec = problems["plain"]
    _, seq = problems["sequential"]
    U0s = np.zeros((2, H - 1, 7))
    with pytest.raises(ValueError, match=r"override 'Rt' must be \[B, 7\]"):
        solve_batch(spec, {"Rt": np.ones((2, 6))}, U0s, 2)
    with pytest.raises(ValueError, match=r"override 'dt' must be \[B\]"):
        solve_batch(spec, {"dt": np.ones((2, 1))}, U0s, 2)
    with pytest.raises(ValueError, match="unknown per-scenario overrides"):
        solve_batch(spec, {"robot": np.ones(2)}, U0s, 2)
    with pytest.raises(ValueError, match="no solver reads 'dq0'"):
        solve_batch(spec, {"dq0": np.zeros((2, 7))}, U0s, 2)
    with pytest.raises(ValueError, match="one entry per subsystem"):
        solve_batch(seq, {"dt": np.full(2, 0.05)}, U0s, 2)
    lanes = solve_batch(seq, {"Rt": np.full((2, 7), 1e-5)}, U0s, 2)
    np.testing.assert_allclose(lanes.cost.numpy(),
                               solve_batch(seq, {}, U0s, 2).cost.numpy(),
                               rtol=1e-10)
