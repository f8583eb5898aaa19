"""Standalone linear-quadratic tracker for fixed (A, B) and per-step Q.

PyTorch counterpart of the JAX package's `solvers/lqt.py` (reference:
lqt.cpp:16-128). Two solution paths:
  * solve_dp: the Riccati backward recursion (lqt.cpp:29-53), sequential
    (`riccati`) or by parallel-prefix scans (`riccati_parallel`), with
    per-step closed-loop commands u = K_t (mu_t - x) + f_t computed on
    demand, including the reference's aim-at-the-next-state indexing
    (lqt.cpp:102-120);
  * solve_linalg: the dense batch least squares
    u = (Su^T Q Su + R)^-1 Su^T Q (mu - Sx mu_0) with Sx/Su built by powers
    of A (lqt.cpp:55-89).

The functions take tensors and compute on their device; the `LQT` class
puts its arrays on `device` (None: CUDA). Float32 matmuls keep full
precision: the port leaves `torch.backends.cuda.matmul.allow_tf32` False
and the float32 matmul precision at "highest", their defaults.
"""

import torch

from ilqr_planner_torch.ops import pscan as pscan_ops
from ilqr_planner_torch.ops.linalg import solve_spd
from ilqr_planner_torch.utils.device import resolve_device

__all__ = ["LQT", "riccati", "riccati_parallel", "batch_solution"]


def _mT(a):
    return a.transpose(-1, -2)


def riccati(A, B, Qs, Rt, mu):
    """Backward Riccati recursion (lqt.cpp:29-53).

    A [nx, nx], B [nx, nu], Qs [N, nx, nx], Rt [nu, nu], mu [N * nx].
    Returns (Ps [N, nx, nx], ds [N, nx]) in forward time order: Ps[t] is the
    value Hessian at step t.
    """
    nx = A.shape[0]
    N = Qs.shape[0]
    mu_t = mu.reshape(N, nx)
    Ps = Qs.new_empty(Qs.shape)
    ds = mu_t.new_empty((N, nx))
    P, d = Qs[-1], mu_t.new_zeros(nx)
    Ps[-1], ds[-1] = P, d
    for i in range(N - 2, -1, -1):
        BtPB = B.T @ P @ B + Rt
        G = solve_spd(BtPB, B.T @ P)              # (B'PB+R)^-1 B'P
        Pn = Qs[i] - A.T @ (P @ B @ G - P) @ A
        dn = (A.T - A.T @ P @ B @ solve_spd(BtPB, B.T)) @ (
            P @ (A @ mu_t[i] - mu_t[i + 1]) + d)
        P, d = Pn, dn
        Ps[i], ds[i] = P, d
    return Ps, ds


def riccati_parallel(A, B, Qs, Rt, mu):
    """riccati() by parallel-prefix scans: O(log N) depth instead of N
    sequential steps (same inputs and outputs; see ops.pscan).

    The value Hessians P_t come from the associative cost-to-go scan (no
    linear stage cost); the feedforward recursion d_t = E_t (P_{t+1}
    (A mu_t - mu_{t+1}) + d_{t+1}) with E_t = A^T (I - P_{t+1} B
    (B^T P_{t+1} B + R)^{-1} B^T) is affine in d, so a second associative
    scan over (matrix, offset) pairs gives it (ops.pscan.affine_suffix).
    """
    nx, nu = B.shape
    N = Qs.shape[0]
    mu_t = mu.reshape(N, nx)
    As = A.expand(N - 1, nx, nx)
    Bs = B.expand(N - 1, nx, nu)
    zx = Qs.new_zeros((N - 1, nx))
    zu = Qs.new_zeros((N - 1, nu))
    Ps, _ = pscan_ops.lqr_cost_to_go(As, Bs, zx, zu, Qs[:-1],
                                     Qs.new_zeros(nx), Qs[-1],
                                     torch.diagonal(Rt))
    P1 = Ps[1:]
    BtPB = _mT(B) @ P1 @ B + Rt
    Es = A.T - A.T @ P1 @ B @ solve_spd(BtPB, B.T.expand(N - 1, nu, nx))
    vs = (Es @ (P1 @ ((mu_t[:-1] @ A.T) - mu_t[1:])[..., None]))[..., 0]
    ds = pscan_ops.affine_suffix(Es, vs)
    return Ps, ds


def batch_solution(A, B, Qs, Rt_scalar, mu, nb_deriv: int = 1):
    """Dense batch solve (lqt.cpp:55-89) -> (u [(N-1) nu], Sx [N nx, nx],
    Su [N nx, (N-1) nu], Q [N nx, N nx] block diagonal)."""
    nx, nu = B.shape
    N = Qs.shape[0]
    W = (N - 1) * nu
    # M starts as B in block-column 0 (lqt.cpp:62: M = B) and row i
    # captures M as built by iteration i-1, as the reference does
    M = A.new_zeros((nx, W))
    M[:, :nu] = B
    Sx_row = torch.eye(nx, dtype=A.dtype, device=A.device)
    Su = A.new_zeros((N, nx, W))
    Sx = A.new_empty((N, nx, nx))
    Sx[0] = Sx_row
    for i in range(1, N):
        Sx_row = Sx_row @ A
        Su[i], Sx[i] = M, Sx_row
        M = A @ M
        if i < N - 1:
            M[:, i * nu:(i + 1) * nu] = B
    Sx = Sx.reshape(N * nx, nx)
    SuQ = (_mT(Qs) @ Su).reshape(N * nx, W).T   # Su^T Q, Q block-diagonal
    Su = Su.reshape(N * nx, W)
    R = torch.eye(W, dtype=A.dtype, device=A.device) * (Rt_scalar ** nb_deriv)
    rhs = SuQ @ (mu - Sx @ mu[:nx])
    u = torch.linalg.solve(SuQ @ Su + R, rhs)
    return u, Sx, Su, torch.block_diag(*Qs)


class LQT:
    """API-compatible tracker (lqt.h:23-86).

    LQT(A, B, Qs, states, rfactor, nb_deriv, device=...) then either
    solve_dp() + get_command(timestep, curr_state), or solve_linalg() +
    get_command(timestep) / get_predicted_states(). The arrays keep their
    dtype and move to `device` (None: CUDA).
    """

    def __init__(self, A, B, Qs, states, rfactor: float, nb_deriv: int = 1,
                 device=None):
        dev = resolve_device(device)
        self.A, self.B, self.Qs, self.mu = (
            torch.as_tensor(a, device=dev) for a in (A, B, Qs, states))
        self.rfactor = float(rfactor)
        self.nb_deriv = int(nb_deriv)
        self.nb_state_var = self.A.shape[1]
        self.nb_ctrl_var = self.B.shape[1]
        self.nb_states = self.mu.shape[0] // self.nb_state_var
        self.Rt = torch.eye(self.nb_ctrl_var, dtype=self.A.dtype, device=dev) * (
            self.rfactor ** self.nb_deriv)
        self._Ps = None
        self._ds = None
        self._u = None
        self._Sx = None
        self._Su = None

    # -- dynamic programming path ------------------------------------------
    def solve_dp(self, parallel: bool = False):
        """Riccati solve; parallel=True takes the O(log N)-depth
        associative-scan path (riccati_parallel), same results."""
        fn = riccati_parallel if parallel else riccati
        self._Ps, self._ds = fn(self.A, self.B, self.Qs, self.Rt, self.mu)

    def get_command(self, timestep: int, curr_state=None):
        nx = self.nb_state_var
        if curr_state is None:
            if self._u is None:
                raise RuntimeError("solve_linalg() first")
            nu = self.nb_ctrl_var
            return self._u[timestep * nu:(timestep + 1) * nu]
        if self._Ps is None:
            raise RuntimeError("solve_dp() first")
        # The reference aims at state t+1 (lqt.cpp:102-117).
        t = timestep + 1
        Pt = self._Ps[t]
        dt = self._ds[t]
        mu_t = self.mu[t * nx:(t + 1) * nx]
        A, B = self.A, self.B
        BtPB = B.T @ Pt @ B + self.Rt
        Kt = solve_spd(BtPB, B.T @ Pt @ A)
        ft = -solve_spd(BtPB, B.T @ (Pt @ (A @ mu_t - mu_t) + dt))
        x = torch.as_tensor(curr_state, dtype=A.dtype, device=A.device)
        return Kt @ (mu_t - x) + ft

    # -- batch path --------------------------------------------------------
    def solve_linalg(self):
        self._u, self._Sx, self._Su, _ = batch_solution(
            self.A, self.B, self.Qs, self.rfactor, self.mu, self.nb_deriv)

    def get_predicted_states(self):
        if self._u is None:
            raise RuntimeError("solve_linalg() first")
        return self._Su @ self._u + self._Sx @ self.mu[:self.nb_state_var]
