"""Plain statement of a keypoint-tracking problem of a serial arm: the
dynamics, the cost value and the Gauss-Newton cost terms that the solver
uses, batch-first, from a configuration file's numbers.

Kinds:
  posorn       state q [dof], control u [dof], x' = x + dt u;
  posorn_time  state [q, t], control [v, s], q' = q + s^2 v, t' = t + s^2
               (the step's duration is s^2).
The cost, as the upstream planner states it:
  - at each keypoint k: e^T P e, e = [p* - p, -2 E(q*) log(q*, q)] (and
    t* - t for the time kind), with the tip's pose (p, q) from FK;
  - at each keypoint k < H-1: u_k^T diag(Rt) u_k;
  - at every step: w (x - clamp(x, x_min, x_max))^2 over the limited
    coordinates, w the penalty.
The solver's terms (Gauss-Newton, as the planner's): the keypoint gradient
-J^T P e and Hessian J^T P J with J the tip's geometric Jacobian (and a unit
row for the time), the limit gradient w (x - clamp) and Hessian w^2 on the
diagonal, and the control terms Rt u and diag(Rt) at every step.
"""

import torch

from benchmark.reference.kinematics import Chain, rotation_to_quaternion


def _quat_log(base, y):
    """Tangent log map at the unit quaternion base [4] of unit y [B, 4],
    taken on base's hemisphere -> [B, 4]."""
    d = (y * base).sum(-1, keepdim=True)
    y = torch.where(d < 0, -y, y)
    d = d.abs().clamp(max=1.0)
    tangent = y - d * base
    norm = torch.linalg.vector_norm(tangent, dim=-1, keepdim=True)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(norm > 0, torch.arccos(d) * tangent / safe,
                       torch.zeros_like(tangent))


def _quat_rate_matrix(q):
    """E(q) [3, 4] of a quaternion (w, x, y, z)."""
    w, x, y, z = q
    return torch.stack([torch.stack([-x, w, -z, y]), torch.stack([-y, z, w, -x]),
                        torch.stack([-z, -y, x, w])])


class KeypointProblem:
    def __init__(self, cfg, urdf_path, prec):
        self.prec = prec
        self.kind = cfg["kind"]
        if self.kind not in ("posorn", "posorn_time"):
            raise ValueError(f"kind {self.kind!r} is not stated here")
        self.time = self.kind == "posorn_time"
        self.chain = Chain(urdf_path, cfg["base_link"], cfg["tip_link"], prec)
        self.dof = self.chain.dof
        self.n = self.m = self.dof + (1 if self.time else 0)
        self.H = cfg["horizon"]
        self.dt = None if self.time else float(cfg["dt"])
        self.Rt = prec.tensor(cfg["Rt"])
        lim = cfg["joint_limits"]
        pad = [0.0] if self.time else []
        self.x_max = prec.tensor(list(lim["max"]) + pad)
        self.x_min = prec.tensor(list(lim["min"]) + pad)
        self.limited = prec.tensor([1.0] * self.dof + pad)
        self.penalty = float(lim["penalty"])
        self.keypoints = []
        for kp in cfg["keypoints"]:
            q_raw = prec.tensor(kp["orientation"])
            self.keypoints.append({
                "step": int(kp["step"]),
                "p": prec.tensor(kp["position"]),
                "q": q_raw / torch.linalg.vector_norm(q_raw),
                "E": _quat_rate_matrix(q_raw),
                "P": torch.diag(prec.tensor(kp["precision_diag"])),
                "t": float(kp["time"]) if self.time else None})

    # -- dynamics ---------------------------------------------------------

    def step(self, x, u):
        """x [.., n], u [.., m] -> x' [.., n]."""
        if not self.time:
            return x + self.dt * u
        dtk = u[..., -1:] ** 2
        return torch.cat([x[..., :-1] + dtk * u[..., :-1], x[..., -1:] + dtk], -1)

    def step_jacobians(self, x, u):
        """(A [B, n, n], Bu [B, n, m]) at one step."""
        B = x.shape[0]
        eye = torch.eye(self.n, dtype=x.dtype, device=x.device).expand(B, -1, -1)
        if not self.time:
            return eye, self.dt * eye
        s = u[:, -1]
        Bu = torch.zeros(B, self.n, self.m, dtype=x.dtype, device=x.device)
        Bu[:, :-1, :-1] = (s * s)[:, None, None] * torch.eye(
            self.dof, dtype=x.dtype, device=x.device)
        Bu[:, :-1, -1] = 2.0 * s[:, None] * u[:, :-1]
        Bu[:, -1, -1] = 2.0 * s
        return eye, Bu

    # -- cost ---------------------------------------------------------------

    def _residual(self, kp, x, jacobian):
        """e [B, nq] (and J [B, nq, n]) of one keypoint at states x [B, n]."""
        p, R, J6 = self.chain.fk(x[:, :self.dof], jacobian)
        quat = rotation_to_quaternion(R)
        e_p = kp["p"] - p
        e_o = -2.0 * self.prec.mm(kp["E"].expand(x.shape[0], 3, 4),
                                  _quat_log(kp["q"], quat)[..., None])[..., 0]
        parts = [e_p, e_o]
        if self.time:
            parts.append(kp["t"] - x[:, -1:])
        e = torch.cat(parts, -1)
        if not jacobian:
            return e, None
        J = torch.zeros(x.shape[0], e.shape[-1], self.n, dtype=x.dtype,
                        device=x.device)
        J[:, :6, :self.dof] = J6
        if self.time:
            J[:, 6, -1] = 1.0
        return e, J

    def _limit_excess(self, X):
        """X - clamp(X, x_min, x_max) on the limited coordinates."""
        excess = X - torch.minimum(torch.maximum(X, self.x_min), self.x_max)
        return excess * self.limited

    def cost(self, X, U):
        """X [.., B, H, n], U [.., B, H-1, m] -> [.., B]."""
        lead = X.shape[:-2]
        Xf = X.reshape(-1, self.H, self.n)
        Uf = U.reshape(-1, self.H - 1, self.m)
        c = self.penalty * (self._limit_excess(Xf) ** 2).sum((-2, -1))
        for kp in self.keypoints:
            k = kp["step"]
            if k < self.H - 1:
                c = c + (self.Rt * Uf[:, k] ** 2).sum(-1)
            e, _ = self._residual(kp, Xf[:, k], False)
            Pe = self.prec.mm(kp["P"].expand(e.shape[0], -1, -1), e[..., None])[..., 0]
            c = c + (e * Pe).sum(-1)
        return c.reshape(lead)

    def state_terms(self, X):
        """Gauss-Newton terms of the state cost -> (lx [B, H, n],
        Lxx [B, H, n, n])."""
        mm = self.prec.mm
        excess = self._limit_excess(X)
        active = (excess != 0).to(X.dtype)
        lx = self.penalty * excess
        Lxx = torch.diag_embed(active * self.penalty ** 2)
        for kp in self.keypoints:
            k = kp["step"]
            e, J = self._residual(kp, X[:, k], True)
            P = kp["P"].expand(e.shape[0], -1, -1)
            JT = J.transpose(-1, -2)
            lx[:, k] = lx[:, k] - mm(JT, mm(P, e[..., None]))[..., 0]
            Lxx[:, k] = Lxx[:, k] + mm(JT, mm(P, J))
        return lx, Lxx
