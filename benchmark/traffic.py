"""The one generator of traffic: a mix file's parameters -> the inputs of
every call, and the closed loop that drives them through a window.

A mix (`traffic/<name>.json`) states:
  loop, clients          "closed", 1: one client, each call sent when the
                         last one's costs are on the host (the only loop);
  batch                  lanes a call;
  nb_iter                the iteration budget of a call;
  pool                   distinct batches drawn at set-up, taken in turn;
  x0_sigma               a lane's start is the configuration's q0_nominal
                         plus x0_sigma N(0, 1) per joint, then x0_tail;
  warmup_calls           calls at the cell's own shapes before the window;
  sample_lanes_per_call  lanes of each call kept for the check (drawn from
                         the seed);
  check_lanes            the most kept lanes the check compares (a seeded
                         subset of those kept).
Every input is drawn on the device from `--seed` with one generator, in a
few whole-tensor calls.
"""

import time

import torch


class Inputs:
    """The pool of starts, the initial controls and the sample table of one
    run."""

    def __init__(self, cfg, mix, seed, device, max_calls=1 << 14):
        if mix["loop"] != "closed" or int(mix["clients"]) != 1:
            raise ValueError("the generator drives a closed loop of one client; got "
                             f"loop={mix['loop']!r}, clients={mix['clients']!r}")
        dtype = getattr(torch, cfg["dtype"])
        B, P = int(mix["batch"]), int(mix["pool"])
        H = int(cfg["horizon"])
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        q0 = torch.tensor(cfg["q0_nominal"], dtype=dtype, device=device)
        noise = torch.randn((P, B, q0.shape[0]), generator=self.gen,
                            dtype=dtype, device=device)
        tail = torch.tensor(cfg["x0_tail"], dtype=dtype, device=device)
        self.x0 = torch.cat([q0 + float(mix["x0_sigma"]) * noise,
                             tail.expand(P, B, tail.shape[0])], -1).contiguous()
        row = torch.tensor(cfg["u0_row"], dtype=dtype, device=device)
        self.U0 = row.expand(B, H - 1, row.shape[0]).contiguous()
        self.sample = torch.randint(B, (max_calls, int(mix["sample_lanes_per_call"])),
                                    generator=self.gen, device=device)
        self.check_lanes = int(mix["check_lanes"])

    def batch(self, k):
        """The starts of call k."""
        return self.x0[k % self.x0.shape[0]]


class Kept:
    """The sampled lanes of each call of the window: their starts and the
    answers as the timed path returned them (on the device)."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.parts = []

    def keep(self, k, x0s, out):
        idx = self.inputs.sample[k % self.inputs.sample.shape[0]]
        self.parts.append({"x0": x0s[idx], "X": out["X"][idx], "U": out["U"][idx],
                           "cost": out["cost"][idx],
                           "iterations": out["iterations"][idx].to(torch.int64)})

    def drawn(self):
        """Every kept lane, or a seeded subset of `check_lanes` of them ->
        dict of stacked tensors."""
        cat = {key: torch.cat([p[key] for p in self.parts]) for key in self.parts[0]}
        n = cat["cost"].shape[0]
        if n > self.inputs.check_lanes:
            pick = torch.randperm(n, generator=self.inputs.gen,
                                  device=self.inputs.gen.device)[:self.inputs.check_lanes]
            cat = {key: v[pick] for key, v in cat.items()}
        return cat


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(call, inputs, mix, device):
    for k in range(int(mix["warmup_calls"])):
        out = call(inputs.batch(k), inputs.U0)
        sync(device)
        out["cost"].cpu()


def closed_loop(call, inputs, seconds, device, count=None):
    """Calls back to back from one client until `seconds` have passed (no
    call is cut) -> dict(walls (s, host clock, the call until its costs are
    on the host), window_s (from the first call's start to the last one's
    end), calls, lanes, failed (lanes whose cost is not finite), kept,
    counts (what `count()` rose by in each call, if given))."""
    kept = Kept(inputs)
    walls, counts, failed, lanes = [], [], 0, 0
    t_start = time.perf_counter()
    k = 0
    while True:
        c0 = count() if count else 0
        t0 = time.perf_counter()
        x0s = inputs.batch(k)
        out = call(x0s, inputs.U0)
        sync(device)
        cost = out["cost"].cpu()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        counts.append(count() - c0 if count else 0)
        failed += int((~torch.isfinite(cost)).sum())
        lanes += cost.shape[0]
        kept.keep(k, x0s, out)
        del out
        k += 1
        if t1 - t_start >= seconds:
            break
    return {"walls": walls, "window_s": t1 - t_start, "calls": k, "lanes": lanes,
            "failed": failed, "kept": kept, "counts": counts}
