"""One step of the fleet's backward sweep over lane-major tensors.

PyTorch counterpart of `_q_terms`, `_al_terms`, `_solve_aug` and
`_gains_value` in the JAX package's `solvers/fleet.py`. A small matrix is an
[i, j, B] tensor, the scenario lanes last; a constant (Rt, a constraint row)
has no lane axis and broadcasts. The JAX package unrolls each product into
lists of [B] vectors and skips its exact zeros and ones; here the products
run whole, which leaves every value as it was but sums in another order
(about 1 ulp).

Two callers: the fleet's generic sweep (`solvers/fleet.py::_backward`, every
kind, with the AL terms when they are set) and the plain twin of the
whole-sweep kernels (`ops/cuda_kernels/segment_backward_2nd.py`, kinds
'second' and 'time1'), so the twin and the generic sweep share one copy.
"""

import torch

__all__ = ["KINDS", "q_terms", "al_terms", "solve_aug", "gains_value",
           "mirror_upper"]

# The structured dynamics `q_terms` takes: first order (A = I, B = dt I),
# the double integrator, the sqrt-dt time-optimal first order and the
# time-optimal double integrator.
KINDS = ("first", "second", "time1", "time2")


def _bt_time2(M, dof, b1, b2, g1, g2, h):
    """B^T M for the time-optimal double integrator's B (M [n, c, B]): rows
    b1 M_q + b2 M_dq, and the chain-rule row g1 . M_q + g2 . M_dq + h M_t."""
    last = ((g1[:, None] * M[:dof]).sum(0) + (g2[:, None] * M[dof:2 * dof]).sum(0)
            + h * M[-1])
    return torch.cat([b1 * M[:dof] + b2 * M[dof:2 * dof], last[None]])


def q_terms(kind, P, p, l2, lx, u, gxx, dt, b1, Rt, dq=None):
    """Pre-gain Q blocks at one step -> (Quu [m, m, B], Qux [m, n, B],
    Qu [m, B], Qxx [n, n, B], Qx [n, B]).

    'first' (n = m): A = I, B = dt I.
    'second' (n = 2m): A = I + dt E, B = [b1 I; dt I] with b1 = dt^2 / 2.
    'time1' (n = m): A = I, B = [[s^2 I, 2 s u_q], [0, 2 s]], s = u[m-1].
    'time2' (n = 2 dof + 1, m = dof + 1; state [q, dq, t], control
    [ddq, s]): A = I + s^2 E, B = [[s^4/2 I, g1], [s^2 I, g2], [0, 2 s]]
    with the chain-rule column g1 = 2 s dq' + 2 s^3 ddq, g2 = 2 s ddq read
    at the UPDATED velocity dq' = dq + s^2 ddq; `dq` [dof, B] is the
    state's velocity block.
    P [n, n, B], p [n, B], l2/lx [n, B] (the stage Hessian's diagonal and
    the stage gradient), u [m, B], gxx a dense keypoint Hessian [n, n, B] or
    None; dt, b1 scalars (unused by the time kinds) and Rt [m, 1].
    """
    n, m = P.shape[0], u.shape[0]
    eye_m = torch.eye(m, dtype=P.dtype, device=P.device)[:, :, None]
    stage = torch.diag_embed(l2.T).permute(1, 2, 0)
    if gxx is not None:
        stage = stage + gxx
    if kind == "first":
        Quu = (dt * dt) * P + eye_m * Rt[:, :, None]
        return Quu, dt * P, Rt * u + dt * p, P + stage, lx + p
    if kind == "second":
        dof = m
        # P A: dt * (q-columns) added into the dq-columns
        PA = torch.cat([P[:, :dof], P[:, dof:] + dt * P[:, :dof]], dim=1)
        Qux = b1 * PA[:dof] + dt * PA[dof:]
        PB = b1 * P[:, :dof] + dt * P[:, dof:]                   # [n, m, B]
        Quu = b1 * PB[:dof] + dt * PB[dof:] + eye_m * Rt[:, :, None]
        Qu = Rt * u + (b1 * p[:dof] + dt * p[dof:])
        Qx = lx + torch.cat([p[:dof], p[dof:] + dt * p[:dof]])
        # A^T (P A): dt * (q-rows of PA) added into the dq-rows
        Qxx = stage + torch.cat([PA[:dof], PA[dof:] + dt * PA[:dof]])
        return Quu, Qux, Qu, Qxx, Qx
    if kind == "time2":
        dof = m - 1
        s = u[m - 1]
        dtk = s * s
        ddq = u[:dof]
        g1 = 2.0 * s * (dq + dtk * ddq) + 2.0 * (s * s * s) * ddq
        g2 = 2.0 * s * ddq
        h = 2.0 * s
        coef = (0.5 * dtk * dtk, dtk, g1, g2, h)
        # P A: dtk * (q-columns) added into the dq-columns
        PA = torch.cat([P[:, :dof], P[:, dof:2 * dof] + dtk * P[:, :dof],
                        P[:, 2 * dof:]], dim=1)
        PB = _bt_time2(P.transpose(0, 1), dof, *coef).transpose(0, 1)
        Qux = _bt_time2(PA, dof, *coef)
        Quu = _bt_time2(PB, dof, *coef) + eye_m * Rt[:, :, None]
        Qu = Rt * u + _bt_time2(p[:, None], dof, *coef)[:, 0]
        Qx = lx + torch.cat([p[:dof], p[dof:2 * dof] + dtk * p[:dof], p[2 * dof:]])
        # A^T (P A): dtk * (q-rows of PA) added into the dq-rows
        Qxx = stage + torch.cat([PA[:dof], PA[dof:2 * dof] + dtk * PA[:dof],
                                 PA[2 * dof:]])
        return Quu, Qux, Qu, Qxx, Qx
    if kind != "time1":
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    dof = m - 1
    s = u[m - 1]
    dtk = s * s
    h = 2.0 * s
    g = h * u[:dof]                                              # [dof, B]

    def btm(M):
        """B^T M for M [n, c, B]."""
        last = (g[:, None] * M[:dof]).sum(0) + h * M[n - 1]
        return torch.cat([dtk * M[:dof], last[None]])

    PB = torch.cat([dtk * P[:, :dof],
                    ((P[:, :dof] * g[None]).sum(1) + P[:, n - 1] * h)[:, None]],
                   dim=1)                                        # [n, m, B]
    Qux = btm(P)
    Quu = btm(PB) + eye_m * Rt[:, :, None]
    Btp = torch.cat([dtk * p[:dof], ((g * p[:dof]).sum(0) + h * p[n - 1])[None]])
    Qu = Rt * u + Btp
    return Quu, Qux, Qu, P + stage, lx + p


def al_terms(Quu, Qux, Qu, Qxx, Qx, cx, cu, Ik, g, lam):
    """The AL constraint terms added to the Q blocks: with lig = lam + Ik g,
    Qu += cu^T lig, Qux += cu^T Ik cx, Quu += cu^T Ik cu, Qx += cx^T lig,
    Qxx += cx^T Ik cx. cx [nc, n] and cu [nc, m] are the step's constraint
    rows (no lane axis), Ik (the penalty-scaled active set), g (the
    violation) and lam [nc, B]."""
    lig = lam + Ik * g
    Icx = Ik[:, None] * cx[:, :, None]                           # [nc, n, B]
    Icu = Ik[:, None] * cu[:, :, None]
    cu3, cx3 = cu[:, :, None, None], cx[:, :, None, None]
    return (Quu + (cu3 * Icu[:, None]).sum(0),
            Qux + (cu3 * Icx[:, None]).sum(0),
            Qu + (cu[:, :, None] * lig[:, None]).sum(0),
            Qxx + (cx3 * Icx[:, None]).sum(0),
            Qx + (cx[:, :, None] * lig[:, None]).sum(0))


def solve_aug(M, R):
    """Gauss-Jordan without pivoting: M^-1 R for M [m, m, B], R [m, c, B],
    eliminating pivot by pivot in the JAX package's order."""
    A, X = M.clone(), R.clone()
    m = A.shape[0]
    for k in range(m):
        piv = 1.0 / A[k, k]
        A[k] = A[k] * piv
        X[k] = X[k] * piv
        fac = A[:, k].clone()
        fac[k] = 0.0                      # row k keeps its values
        A = A - fac[:, None] * A[k][None]
        X = X - fac[:, None] * X[k][None]
    return X


def gains_value(Quu, Qux, Qu, Qxx, Qx, reg):
    """Regularized gains and the collapsed value update -> (P1 [n, n, B],
    p1 [n, B], K [m, n, B], d [m, B]): with (Quu + reg I)[S | s] = [Qux | Qu],
    K = -S, d = -s, P1 = Qxx + Qux^T K - reg K^T K (upper triangle,
    mirrored) and p1 = Qx + Qux^T d - reg K^T d."""
    m, n = Qux.shape[0], Qux.shape[1]
    eye_m = torch.eye(m, dtype=Quu.dtype, device=Quu.device)[:, :, None]
    sol = solve_aug(Quu + reg * eye_m, torch.cat([Qux, Qu[:, None]], dim=1))
    K, d = -sol[:, :n], -sol[:, n]
    P1 = (Qxx + (Qux[:, :, None] * K[:, None]).sum(0)
          - reg * (K[:, :, None] * K[:, None]).sum(0))
    p1 = Qx + (Qux * d[:, None]).sum(0) - reg * (K * d[:, None]).sum(0)
    return mirror_upper(P1), p1, K, d


def mirror_upper(P):
    """P [n, n, B] with its strict lower triangle taken from the upper."""
    lower = torch.ones(P.shape[:2], dtype=torch.bool, device=P.device).tril(-1)
    return torch.where(lower[:, :, None], P.transpose(0, 1), P)
