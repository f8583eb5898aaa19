"""Port parity on a chain that is not the 7-DoF arm: the Panda from
`panda_link0` to `panda_link6` (6 revolute joints, from the port's own
URDF), through `solve_batch` against the JAX package's solvers on the same
float64 batch (CPU, where the port's kernels run their twins): the fleet's
posorn at nb_deriv 1 and 2 and posorn_time at 1, and the recursive solver's
posorn at 1. On the card these widths are built at first use (the wrappers'
width checks: `tests/test_torch_*` of each kernel).

Tolerances: iterations and alpha equal per lane; cost rtol 1e-9 (as the
7-DoF parity tests).
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, Robot, chain_from_urdf
from ilqr_planner_torch.ops.cuda_kernels import riccati as ric
from ilqr_planner_torch.ops.cuda_kernels import segment_backward as sb
from ilqr_planner_torch.parallel import solve_batch
from ilqr_planner_torch.systems import keypoints as kps_mod
from ilqr_planner_torch.systems.spec import make_spec

DOF, TIP = 6, "panda_link6"
Q0 = np.array([0.62991112, -0.2329776, -0.01423721, -1.70254115, 0.06251303,
               1.50592777])
T1 = ([0.45, -0.05, 0.45], [0.014042440828406944, 0.915047647731553,
                            0.4024820607528928, 0.022333898196169735])
T2 = ([0.30, -0.10, 0.30], [0.029927010072216945, 0.9121514607332729,
                            0.4087591864532181, 0.00011933313484481926])
H, B, NB_ITER = 12, 4, 5
# (kind, nb_deriv, through the fleet)
CASES = (("posorn", 1, True), ("posorn", 2, True), ("posorn_time", 1, True),
         ("posorn", 1, False))


def _keypoints(kind, nb, mod):
    if kind == "posorn_time":
        return [mod.SpacetimeKeypoint(*T1, np.diag([1, 1, 1, .1, .1, .1, 0]), 5, 2.0),
                mod.SpacetimeKeypoint(*T2, np.diag([1, 1, 1, .1, .1, .1, .1]), H - 1,
                                      5.0)]
    prec = np.diag([1, 1, 1, .1, .1, .1] * nb)
    vel = dict(dposition=[0, 0, 0], dorientation=[0, 0, 0, 0]) if nb == 2 else {}
    return [mod.PosOrnKeypoint(*T1, prec, 5, **vel),
            mod.PosOrnKeypoint(*T2, prec, H - 1, **vel)]


def _specs(kind, nb):
    """The same problem for both packages: joint limits q0 +- 0.4 so the
    penalty is live; joint velocity limits +-10 at nb_deriv 2."""
    from ilqr_planner_tpu.models import Robot as JRobot
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.systems import keypoints as jkps_mod
    from ilqr_planner_tpu.systems.spec import make_spec as jmake_spec

    jrobot = JRobot.from_chain(jchain_from_urdf(
        PANDA_URDF.read_text(), "panda_link0", TIP, is_path=False,
        dtype=np.float64, prefer_native=False))
    robot = Robot.from_chain(chain_from_urdf(PANDA_URDF, "panda_link0", TIP,
                                             device="cpu"))
    time_kind = kind.endswith("_time")
    kw = dict(dt=None if time_kind else 0.1, q0=Q0, q_max=Q0 + 0.4,
              q_min=Q0 - 0.4)
    if nb == 2:
        kw.update(dq_max=np.ones(DOF) * 10, dq_min=-np.ones(DOF) * 10)
    Rt = np.ones(DOF + 1 if time_kind else DOF) * 1e-5
    jspec = jmake_spec(kind, jrobot, _keypoints(kind, nb, jkps_mod), Rt, H, nb,
                       dtype=np.float64, **kw)
    spec = make_spec(kind, robot, _keypoints(kind, nb, kps_mod), Rt, H, nb,
                     device="cpu", **kw)
    return jspec, spec


def _batch(spec, seed=0):
    """(x0s [B, n], U0s [B, H-1, m]): q0 + 0.05 N(0, 1), zero velocity and
    time, zero controls with the time kind's step control s = 0.1."""
    rng = np.random.default_rng(seed)
    q0s = Q0[None] + 0.05 * rng.normal(size=(B, DOF))
    x0s = np.concatenate([q0s, np.zeros((B, spec.nx - DOF))], axis=-1)
    U0s = np.zeros((B, H - 1, spec.nu))
    if spec.time_optimal:
        U0s[..., -1] = 0.1
    return x0s, U0s


@pytest.mark.parametrize("kind,nb,fleet", CASES,
                         ids=["posorn-1", "posorn-2", "posorn_time-1",
                              "posorn-1-recursive"])
def test_solve_batch_on_a_6dof_chain_matches_jax(kind, nb, fleet):
    from ilqr_planner_tpu.parallel import solve_batch as jsolve_batch

    jspec, spec = _specs(kind, nb)
    assert spec.nx == (2 * DOF if nb == 2 else DOF + (kind == "posorn_time"))
    x0s, U0s = _batch(spec, seed=nb)
    ov = {"q0": x0s[:, :DOF], "x0": x0s}
    ref = jsolve_batch(jspec, ov, U0s, NB_ITER, prefer_fleet=fleet)
    before = (sb.LAUNCHES, ric.LAUNCHES)
    got = solve_batch(spec, ov, U0s, NB_ITER, prefer_fleet=fleet)
    assert (sb.LAUNCHES, ric.LAUNCHES) == before     # the CPU runs the twins
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-9,
                               atol=0)
    assert got.U.shape == (B, H - 1, spec.nu) == np.asarray(ref.U).shape
    assert int(got.iterations.max()) >= 2
    assert torch.isfinite(got.cost).all()
