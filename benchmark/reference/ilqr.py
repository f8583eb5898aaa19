"""Plain iterative LQR over a batch of independent problems.

The algorithm is the upstream planner's recursive iLQR, stated as
textbook iLQR and computed batch-first in plain PyTorch:

  - start: roll U0 out open loop from x0;
  - each iteration of a lane that is still running: the backward pass
    (Q terms from the step Jacobians, gains from (Quu + reg I) with the
    ridge reg = 1e-6, the value function through the gains), then the line
    search over alpha = 1, 1/2, ..., 2^-10: u = u_ref + K (x - x_ref) +
    alpha d rolled out closed loop, the first alpha whose cost is below the
    lane's cost is taken; where none is, the last (2^-10) is taken anyway;
  - a lane stops after `nb_iter` iterations, or once alpha *
    sqrt(sum_k ||du_k||) < 1e-3 and its cost < 1e-3.

All eleven trials of an iteration are rolled out together on a leading
axis. Imports nothing of the program.
"""

import torch

REG = 1e-6
ALPHAS = [2.0 ** -i for i in range(11)]
STOP_STEP = 1e-3
STOP_COST = 1e-3


def rollout(problem, x0, X_ref, U_ref, K, d, alphas):
    """Closed-loop rollouts for each alpha -> (X [A, B, H, n], U [A, B, H-1, m],
    du_norm_sum [A, B]). x0 [B, n]; X_ref [B, H, n], U_ref [B, H-1, m];
    K [B, H-1, m, n], d [B, H-1, m]; alphas [A]."""
    mm = problem.prec.mm
    A = alphas.shape[0]
    x = x0.expand(A, *x0.shape)
    X, U, du_norm = [x], [], 0.0
    for k in range(problem.H - 1):
        dx = x - X_ref[:, k]
        du = (mm(K[:, k].expand(A, *K[:, k].shape), dx[..., None])[..., 0]
              + alphas[:, None, None] * d[:, k])
        u = U_ref[:, k] + du
        du_norm = du_norm + torch.linalg.vector_norm(du, dim=-1)
        x = problem.step(x, u)
        X.append(x)
        U.append(u)
    return torch.stack(X, -2), torch.stack(U, -2), du_norm


def backward(problem, X, U):
    """Gains K [B, H-1, m, n], d [B, H-1, m] about the trajectory."""
    mm = problem.prec.mm
    B, H = X.shape[0], problem.H
    lx, Lxx = problem.state_terms(X)
    Rt = problem.Rt
    R = torch.diag_embed(Rt).expand(B, -1, -1)
    ridge = REG * torch.eye(problem.m, dtype=X.dtype, device=X.device)
    P, p = Lxx[:, H - 1], lx[:, H - 1]
    Ks = X.new_empty((B, H - 1, problem.m, problem.n))
    ds = X.new_empty((B, H - 1, problem.m))
    for t in range(H - 2, -1, -1):
        A, Bu = problem.step_jacobians(X[:, t], U[:, t])
        AT, BT = A.transpose(-1, -2), Bu.transpose(-1, -2)
        PA, PB = mm(P, A), mm(P, Bu)
        Quu = mm(BT, PB) + R
        Qux = mm(BT, PA)
        Qxx = mm(AT, PA) + Lxx[:, t]
        Qu = Rt * U[:, t] + mm(BT, p[..., None])[..., 0]
        Qx = mm(AT, p[..., None])[..., 0] + lx[:, t]
        sol = torch.linalg.solve(Quu + ridge, torch.cat([Qux, Qu[..., None]], -1))
        K, d = -sol[..., :-1], -sol[..., -1]
        KT = K.transpose(-1, -2)
        P = Qxx + mm(KT, mm(Quu, K)) + mm(KT, Qux) + mm(Qux.transpose(-1, -2), K)
        P = 0.5 * (P + P.transpose(-1, -2))
        p = (Qx + mm(KT, mm(Quu, d[..., None]))[..., 0] + mm(KT, Qu[..., None])[..., 0]
             + mm(Qux.transpose(-1, -2), d[..., None])[..., 0])
        Ks[:, t], ds[:, t] = K, d
    return Ks, ds


def solve(problem, x0, U0, nb_iter):
    """x0 [B, n], U0 [B, H-1, m] in the problem's precision -> dict of X
    [B, H, n], U [B, H-1, m], cost [B], iterations [B] (int64)."""
    B = x0.shape[0]
    prec = problem.prec
    alphas = prec.tensor(ALPHAS)
    zero_K = x0.new_zeros((B, problem.H - 1, problem.m, problem.n))
    X, U, _ = rollout(problem, x0, x0.new_zeros((B, problem.H, problem.n)), U0,
                      zero_K, torch.zeros_like(U0), alphas[:1])
    X, U = X[0], U[0]
    cost = problem.cost(X, U)
    iters = torch.zeros(B, dtype=torch.int64, device=x0.device)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    while True:
        active = ~done & (iters < nb_iter)
        if not bool(active.any()):
            break
        K, d = backward(problem, X, U)
        Xa, Ua, du_norm = rollout(problem, x0, X, U, K, d, alphas)
        ca = problem.cost(Xa, Ua)                              # [A, B]
        ok = ca < cost
        last = len(ALPHAS) - 1
        pick = torch.where(ok.any(0), ok.to(torch.int8).argmax(0),
                           torch.full_like(iters, last))
        lanes = torch.arange(B, device=x0.device)
        Xn, Un, cn = Xa[pick, lanes], Ua[pick, lanes], ca[pick, lanes]
        alpha = alphas[pick]
        stop = (alpha * torch.sqrt(du_norm[pick, lanes]) < STOP_STEP) & (cn < STOP_COST)
        X = torch.where(active[:, None, None], Xn, X)
        U = torch.where(active[:, None, None], Un, U)
        cost = torch.where(active, cn, cost)
        iters = iters + active.to(iters.dtype)
        done = done | (active & stop)
    return {"X": X, "U": U, "cost": cost, "iterations": iters}
