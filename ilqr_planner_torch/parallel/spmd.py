"""SPMD fleet execution: a 2-D mesh of ranks with torch.distributed
collectives.

PyTorch counterpart of the JAX package's `parallel/spmd.py`. Two axes:

  dp  scenario data parallelism: each rank solves its slice of the
      scenario batch; the mean cost is averaged over the axis.
  sp  sequence parallelism over the batch iLQR's control-time axis
      (`solve_batch_sp`): each rank holds (H-1)/n of the control rows and
      its columns of the closed-form Su; the keypoint states, the
      Woodbury Gram matrix, the control cost and the line-search costs are
      summed over the axis (`all_reduce`), so the result is the one-device
      `batch.solve`'s up to the order of the sums.

`fleet_step` runs both in one step.
"""

from typing import Dict

import torch

from ilqr_planner_torch.parallel.mesh import Mesh, _lane_spec, _shard, solve_batch
from ilqr_planner_torch.solvers import batch as batch_solver
from ilqr_planner_torch.solvers.batch import BatchResult
from ilqr_planner_torch.solvers.fleet import fleet_supported
from ilqr_planner_torch.systems import funcs
from ilqr_planner_torch.systems.spec import Spec

__all__ = ["fleet_step", "solve_batch_sp"]


def _sp_solve_shard(spec: Spec, x0, Q, U0_local, kp_idx, nb_iter: int,
                    early_stop: bool, mesh: Mesh, sp_axis: str):
    """This rank's part of the sequence-parallel batch solve from x0 [nx]:
    U0_local [(H-1)/n, nu] is its slice of the control-time axis. The
    numerics of the JAX package's shard body (the Woodbury step with the
    Gram matrix P = Su D^-1 Su^T and g = Su D^-1 rhs summed over the
    ranks); every sum over time is an all_reduce over `sp_axis`, three an
    iteration. -> (U_local, cost, iterations)."""
    nu = spec.nu
    dtype, dev = U0_local.dtype, U0_local.device
    n_local = U0_local.shape[0]
    js = mesh.index(sp_axis) * n_local + torch.arange(n_local, device=dev)
    ks = torch.tensor(kp_idx, device=dev)
    ks_prev = (ks - 1).clamp(min=0)
    n_kp, nx = len(kp_idx), spec.nx

    Su = batch_solver._lti_su_rows(spec, ks, dtype, js)     # [n_kp nx, W_local]
    Rd = spec.Rt.to(dtype).repeat(n_local)
    m = Su.shape[0]
    base = torch.stack([batch_solver._lti_states_base(spec, x0, k)
                        for k in (ks, ks_prev)])           # [2, n_kp, nx]
    alphas = 2.0 ** -torch.arange(0, 11, dtype=dtype, device=dev)

    def partial_states(U):
        """Both rows' control parts of U [.., n_local, nu] -> [.., 2 n_kp nx]."""
        return torch.cat([batch_solver._lti_states_partial(spec, U, k, js)
                          for k in (ks, ks_prev)], dim=-2).flatten(-2)

    def kp_terms(summed):
        """(e, ql, Lblk, Jblk) from the all-reduced partial states."""
        X = base + summed.unflatten(-1, (2, n_kp, nx))
        fX_kp, J = funcs.fx_jac(spec, X[..., 0, :, :])
        e, ql, Lblk = batch_solver._kp_rows(spec, fX_kp, X[..., 1, :, :], ks)
        return e, ql, Lblk, batch_solver._block_diag_lanes(J)

    u = U0_local.reshape(-1)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    cost_l = torch.full((), float("inf"), dtype=dtype, device=dev)
    for _ in range(nb_iter):
        # the states at the keypoint rows and the control cost of u
        sums = mesh.all_reduce(torch.cat([partial_states(u.view(n_local, nu)),
                                          (Rd * u * u).sum()[None]]), sp_axis)
        e, ql, Lblk, Jblk = kp_terms(sums[:-1])
        M = Jblk.T @ Q @ Jblk + torch.diag(Lblk)
        rhs = Su.T @ (Jblk.T @ (Q @ e) + Lblk * ql) - Rd * u
        SuD = Su / Rd[None, :]
        Pg = mesh.all_reduce(torch.cat([SuD @ Su.T, (SuD @ rhs)[:, None]], 1),
                             sp_axis)
        Pm, g = Pg[:, :-1], Pg[:, -1]
        inner = torch.eye(m, dtype=dtype, device=dev) + Pm @ M
        y = M @ torch.linalg.solve(inner, g)
        du = rhs / Rd - (Su.T @ y) / Rd
        cost0 = e @ (Q @ e) + sums[-1] + (ql * Lblk * ql).sum()

        # all 11 trials and |du|^2 in one sum over the ranks
        ut = u + alphas[:, None] * du                      # [11, W_local]
        sums = mesh.all_reduce(torch.cat([
            torch.cat([partial_states(ut.view(11, n_local, nu)),
                       (Rd * ut * ut).sum(-1)[:, None]], 1).flatten(),
            (du * du).sum()[None]]), sp_axis)
        trial = sums[:-1].view(11, -1)
        e2, ql2, L2, _ = kp_terms(trial[:, :-1])
        costs = ((e2 * (e2 @ Q)).sum(-1) + trial[:, -1]
                 + (ql2 * L2 * ql2).sum(-1))
        ok = (costs < cost0) | (alphas < 1e-3)
        alpha = alphas[torch.argmax(ok.to(torch.int32))]
        new_done = done | (early_stop & (alpha * torch.sqrt(sums[-1]) < 1e-3))
        u = torch.where(done, u, u + alpha * du)
        it = torch.where(done, it, it + 1)
        cost_l = torch.where(done, cost_l, cost0)
        done = new_done
    return u.view(n_local, nu), cost_l, it


def solve_batch_sp(spec: Spec, kp_idx, nb_iter: int, u0, mesh: Mesh,
                   sp_axis: str = "sp", early_stop: bool = True,
                   Q=None) -> BatchResult:
    """Sequence-parallel BatchILQR solve of one problem: the (H-1)-step
    control-time axis sharded over `sp_axis`, the Gauss-Newton iteration
    run by every rank of it. The result (on every rank: u gathered over
    the axis) is `batch.solve`'s up to the order of the sums. Raises
    ValueError unless the dynamics have the closed form (not
    time-optimal, every Rt > 0) and the axis size divides H-1."""
    kp_idx = tuple(int(k) for k in kp_idx)
    if Q is None:
        Q = batch_solver.sparse_Q(spec, kp_idx)
    if not batch_solver.fast_supported(spec) or spec.time_optimal:
        raise ValueError("solve_batch_sp requires closed-form constant-A/B "
                         "dynamics (non-time-optimal, positive R)")
    H, nu = spec.horizon, spec.nu
    n_sp = mesh.shape[sp_axis]
    if (H - 1) % n_sp:
        raise ValueError(f"H-1={H - 1} must divide the sp axis size {n_sp}")
    n_local = (H - 1) // n_sp
    U0 = torch.as_tensor(u0, dtype=spec.dtype, device=spec.device).reshape(H - 1, nu)
    i = mesh.index(sp_axis)
    Q = torch.as_tensor(Q, dtype=spec.dtype, device=spec.device)
    U, cost, it = _sp_solve_shard(spec, spec.x0, Q,
                                  U0[i * n_local:(i + 1) * n_local], kp_idx,
                                  int(nb_iter), bool(early_stop), mesh, sp_axis)
    return BatchResult(u=mesh.all_gather(U, sp_axis).reshape(-1), cost=cost,
                       iterations=it)


def fleet_step(spec: Spec, overrides: Dict[str, torch.Tensor], U0s, kp_idx,
               nb_iter: int, mesh: Mesh, dp_axis: str = "dp",
               sp_axis: str = "sp"):
    """One fleet step on a 2-D (dp, sp) mesh.

    - The scenarios shard over dp: each rank solves its slice (the same on
      every rank of sp) with the lane-major fleet when the overrides are
      only the initial state ('x0' / 'q0') and the spec is in the fleet's
      scope, else with the recursive route; the mean final cost is
      averaged over dp.
    - Each dp shard's scenario 0 runs the sequence-parallel batch solve
      over sp (`solve_batch_sp`'s shard body); its cost is averaged over
      dp.

    Returns (costs [B], mean_cost, U_sp [H-1, nu], batch_cost,
    batch_iterations) on every rank; U_sp and batch_iterations are dp
    shard 0's, as the JAX package's replicated outputs read them.
    """
    kp_idx = tuple(int(k) for k in kp_idx)
    H = spec.horizon
    n_dp, n_sp = mesh.shape[dp_axis], mesh.shape[sp_axis]
    if (H - 1) % n_sp:
        raise ValueError(f"H-1={H - 1} must divide the sp axis size {n_sp}")
    U0s = torch.as_tensor(U0s, dtype=spec.dtype, device=spec.device)
    ov, U0 = _shard(mesh, dp_axis, overrides, U0s, spec.device)
    use_fleet = (bool({"q0", "x0"} & set(overrides))
                 and set(overrides) <= {"q0", "x0"} and fleet_supported(spec))
    res = solve_batch(spec, ov, U0, int(nb_iter), prefer_fleet=use_fleet)
    mean_cost = mesh.all_reduce(res.cost.mean(), dp_axis) / n_dp

    first, x0 = _lane_spec(spec, ov, 0)
    n_local = (H - 1) // n_sp
    i = mesh.index(sp_axis)
    U_sp, bcost, bit = _sp_solve_shard(
        first, x0, batch_solver.sparse_Q(spec, kp_idx),
        U0[0, i * n_local:(i + 1) * n_local], kp_idx, int(nb_iter), True,
        mesh, sp_axis)
    bcost = mesh.all_reduce(bcost, dp_axis) / n_dp
    U_sp = mesh.broadcast(mesh.all_gather(U_sp, sp_axis), dp_axis)
    bit = mesh.broadcast(bit, dp_axis)
    return mesh.all_gather(res.cost, dp_axis), mean_cost, U_sp, bcost, bit
