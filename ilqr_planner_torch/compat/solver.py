"""PyLQR.solver: solver classes over System wrappers (bindings.cpp:695-869).

The port's counterpart of the JAX package's `compat/solver.py`: the same
constructor and solve signatures as the reference. solve() runs the port's
solvers on the system's Spec (on its device) and returns numpy results in
the reference's shapes (lists of per-step vectors become [T, dim] arrays,
which the tutorials' `np.asarray(...)` handles identically).
"""

from typing import List

import numpy as np
import torch

from ilqr_planner_torch.compat.system import System
from ilqr_planner_torch.solvers import al_ilqr as _al
from ilqr_planner_torch.solvers import batch as _batch
from ilqr_planner_torch.solvers import ilqr as _ilqr
from ilqr_planner_torch.solvers.lqt import LQT as _LQT

__all__ = ["ILQRRecursive", "AL_ILQR", "Constraint", "BatchILQR",
           "BatchILQRCP", "LQT"]


def _np(t):
    return t.detach().cpu().numpy()


class ILQRRecursive:
    """ILQRRecursive(s); solve(U0, nb_iter, line_search, early_stop, cb=None,
    guard=False) -> (X, f_X, U, Ks, ds, cost) (bindings.cpp:840-859)."""

    def __init__(self, s: System):
        self.s = s

    def solve(self, U0, nb_iter, line_search=True, early_stop=True, cb=None,
              guard=False):
        spec = self.s.spec
        U0 = np.asarray(U0, float).reshape(spec.horizon - 1, spec.nu)
        res = _ilqr.solve(spec, U0, nb_iter, line_search, early_stop,
                          callback=cb, guard=guard)
        self.s.reset()
        return (_np(res.X), _np(res.fX), _np(res.U), _np(res.Ks), _np(res.ds),
                float(res.cost))


class Constraint:
    """A S <= b constraint container (AL-ILQR.h:19-22, bindings.cpp:723)."""

    def __init__(self):
        self.A = np.zeros((0, 0))
        self.b = np.zeros(0)


class AL_ILQR:
    """AL_ILQR(s, inequality, initLambda); solve(U0, nb_iter,
    lag_update_step, penalty, scaling_factor, line_search, early_stop, cb)
    -> (X, f_X, U) (bindings.cpp:733-770). The per-step constraints are
    zero-padded to the widest step's rows and, with the per-step initial
    multipliers, held on the spec's device."""

    def __init__(self, s: System, inequality: List[Constraint], initLambda):
        self.s = s
        spec = s.spec
        H = spec.horizon
        if len(inequality) != H - 1:
            raise ValueError(f"need {H - 1} per-step constraints")
        nc = max((np.asarray(c.b).shape[0] for c in inequality), default=0)
        ns = spec.nx + spec.nu
        A = np.zeros((H - 1, nc, ns))
        b = np.zeros((H - 1, nc))
        lam = np.zeros((H - 1, nc))
        for k, c in enumerate(inequality):
            ck = np.asarray(c.A, float)
            if ck.size:
                A[k, : ck.shape[0], : ck.shape[1]] = ck
                b[k, : np.asarray(c.b).shape[0]] = np.asarray(c.b, float)
            lk = np.asarray(initLambda[k], float)
            lam[k, : lk.shape[0]] = lk

        def t(a):
            return torch.as_tensor(a, dtype=spec.dtype, device=spec.device)

        self.constraints = _al.Constraints(A=t(A), b=t(b))
        self.init_lambda = t(lam)

    def solve(self, U0, nb_iter, lag_update_step, penalty, scaling_factor,
              line_search=True, early_stop=True, cb=None):
        spec = self.s.spec
        U0 = np.asarray(U0, float).reshape(spec.horizon - 1, spec.nu)
        res = _al.solve(spec, self.constraints, self.init_lambda, U0,
                        nb_iter, lag_update_step, penalty, scaling_factor,
                        line_search, early_stop, callback=cb)
        self.s.reset()
        return _np(res.X), _np(res.fX), _np(res.U)


class BatchILQR:
    """BatchILQR(s[, Q]); solve(nb_iter, u0, early_stop, cb=None) -> u
    (bindings.cpp:778-796)."""

    def __init__(self, s: System, Q=None):
        self.s = s
        self.Q = Q

    def solve(self, nb_iter, u0, early_stop=True, cb=None):
        res = _batch.solve(self.s.spec, tuple(self.s.get_kp_indexes()),
                           nb_iter, np.asarray(u0, float).reshape(-1),
                           early_stop, callback=cb, Q=self.Q)
        self.s.reset()
        return _np(res.u)


class BatchILQRCP:
    """BatchILQRCP(s, psi) or (s, Q, psi); solve(nb_iter, u0, early_stop, cb)
    -> u (bindings.cpp:800-829)."""

    def __init__(self, s: System, Q_or_psi=None, psi=None):
        self.s = s
        if psi is None:
            self.Q, self.psi = None, Q_or_psi
        else:
            self.Q, self.psi = Q_or_psi, psi

    def solve(self, nb_iter, u0, early_stop=True, cb=None):
        res = _batch.solve_cp(self.s.spec, self.psi,
                              tuple(self.s.get_kp_indexes()), nb_iter,
                              np.asarray(u0, float).reshape(-1), early_stop,
                              callback=cb, Q=self.Q)
        self.s.reset()
        return _np(res.u)


class LQT(_LQT):
    """Reference-name aliases over solvers.lqt.LQT (bindings.cpp:862-869),
    on `device` (None: CUDA); commands and predicted states come back as
    numpy."""

    def solve_DP(self):
        return self.solve_dp()

    def solve_lin_al(self):
        return self.solve_linalg()

    def get_nb_states(self):
        return self.nb_states

    def get_command(self, timestep, curr_state=None):
        return _np(super().get_command(timestep, curr_state))

    def get_predicted_states(self):
        return _np(super().get_predicted_states())
