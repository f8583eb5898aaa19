"""The affine-family kernel's wrapper and its call site in the fleet
solver, on the CPU; the kernel against its twin on the card (marked
`cuda`).

On the CPU the fleet's `_affine_family` runs the twin
(`affine_family_reference`), which is the fleet's per-step tensor loop as
it ran before the kernel (kept below as `_old_affine_family`): the twin and
whole solves of the first-order, double-integrator, planar and sequential
specs are held to it bit for bit. On the card the kernel sums each row of
the gain product in its own order, so float64 is held to 1e-12 of the twin
and float32 to the twin's own float32 error against float64. No JAX here:
the card tests run on a machine without it.
"""

import re

import numpy as np
import pytest
import torch

from ilqr_planner_torch.ops.cuda_kernels import affine_family as af
from ilqr_planner_torch.ops.cuda_kernels import nvcc_build
from ilqr_planner_torch.solvers import fleet

from test_torch_kp_cost import DTYPES, _batch, _same_bits, _spec

NAMES = ("Xb", "Xd", "Ub", "Ud", "qa", "qb", "qc")
# spec -> the kernel's width (n, m); every one of them an LTI kind
LTI = {"posorn": (7, 7), "posorn2nd": (14, 7), "two_frames": (7, 7),
       "hybrid": (7, 7), "planar": (3, 3)}


# ---------------------------------------------------------------------------
# the fleet's affine family before the kernel
# ---------------------------------------------------------------------------

def _old_affine_family(cc, Ks, ds, Xref, Uref, x0):
    H, dt, dof = cc.H, cc.dt, cc.dof
    B = x0.shape[-1]
    zX = torch.zeros_like(Xref[:-1])
    ref_x = torch.stack([Xref[:-1], zX], dim=1)
    ref_u = torch.stack([Uref, torch.zeros_like(Uref)], dim=1)
    Xbd = x0.new_empty((H, 2) + tuple(x0.shape))
    Xbd[0, 0] = x0
    Xbd[0, 1] = 0.0
    DU = x0.new_empty((H - 1, 2, cc.m, B))
    xbd = Xbd[0]
    for k in range(H - 1):
        du = (Ks[k][None] * (xbd - ref_x[k])[:, None]).sum(2)
        du[1] += ds[k]
        DU[k] = du
        v = du + ref_u[k]
        if cc.nb_deriv == 2:
            q, dq = xbd[:, :dof], xbd[:, dof:]
            xbd = torch.cat([q + dt * dq + (0.5 * dt * dt) * v, dq + dt * v],
                            dim=1)
        else:
            xbd = xbd + dt * v
        Xbd[k + 1] = xbd
    dub, dud = DU[:, 0], DU[:, 1]
    return (Xbd[:, 0], Xbd[:, 1], Uref + dub, dud, (dub * dub).sum(1),
            (dub * dud).sum(1), (dud * dud).sum(1))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _inputs(Hm1, n, m, B, seed, dtype=torch.float64, device="cpu"):
    """Gains that keep the closed loop stable over the horizon (-I/2 on the
    first m columns plus 0.05 N(0, 1)), the rest N(0, 1), drawn on the CPU
    in float64 -> [Ks, ds, Xref, Uref, x0] in `dtype` on `device`."""
    rng = np.random.default_rng(seed)
    K = 0.05 * rng.normal(size=(Hm1, m, n, B))
    K[:, np.arange(m), np.arange(m)] -= 0.5
    arrays = [K, rng.normal(size=(Hm1, m, B)), rng.normal(size=(Hm1 + 1, n, B)),
              rng.normal(size=(Hm1, m, B)), rng.normal(size=(n, B))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _solve_inputs(kind, dtype, B=5, seed=2):
    """The family's inputs at a fleet solve's second iteration: the gains
    of a backward sweep over the trajectories after one iteration."""
    spec = _spec(kind, dtype)
    cc = fleet._Consts(spec)
    x0s, U0s = _batch(spec, B, seed, scale=0.3)
    res = fleet.make_fleet_solver(spec, 1)(x0s, U0s)
    X = res.X.permute(1, 2, 0).contiguous()
    U = res.U.permute(1, 2, 0).contiguous()
    Ks, ds = fleet._backward(cc, X, U)
    return cc, (Ks, ds, X, U, X[0].contiguous())


# ---------------------------------------------------------------------------
# the wrapper and the call site (CPU)
# ---------------------------------------------------------------------------

def _bad_calls():
    """Calls the kernel cannot take, each with the error it raises."""
    Ks, ds, X, U, x0 = _inputs(4, 7, 7, 8, 0, torch.float32)
    strided = torch.zeros(8, 7, dtype=torch.float32).T
    return {
        "cpu_tensors": ((Ks, ds, X, U, x0, 0.1, False), ValueError, "CUDA tensors"),
        "float16": ((Ks.half(), ds.half(), X.half(), U.half(), x0.half(), 0.1,
                     False), TypeError, "float32/float64"),
        "mixed_dtype": ((Ks, ds.double(), X, U, x0, 0.1, False), TypeError,
                        "ds is torch.float64"),
        "shape_Xref": ((Ks, ds, X[:-1], U, x0, 0.1, False), ValueError,
                       "Xref has shape"),
        "shape_batch": ((Ks, ds, X, U[..., :4], x0, 0.1, False), ValueError,
                        "Uref has shape"),
        "not_contiguous": ((Ks, ds, X, U, strided, 0.1, False), ValueError,
                           "x0 is not contiguous"),
        "gains_3d": ((Ks[0], ds, X, U, x0, 0.1, False), ValueError,
                     "horizon H >= 2"),
        "first_order_width": ((Ks[:, :3], ds[:, :3], X, U[:, :3], x0, 0.1,
                               False), ValueError, "n = m"),
        "second_order_width": ((Ks, ds, X, U, x0, 0.1, True), ValueError,
                               "n = 2m"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises_on_what_it_cannot_take(case):
    """The wrapper raises before any launch on tensors off the card, a type
    other than float32/float64 or mixed types, a shape other than the
    gains', rows that are not contiguous, and a width that is not the
    dynamics' (n = m first order, n = 2m the double integrator); the device
    is checked last, so the rest is checked here."""
    args, err, match = _bad_calls()[case]
    before = af.LAUNCHES
    with pytest.raises(err, match=re.escape(match)):
        af.affine_family(*args)
    assert af.LAUNCHES == before


def test_wrapper_raises_above_the_widest_block():
    """A width whose block does not fit one SM raises, naming the limit;
    the widest that fits, fits."""
    for (second, dtype), top in af.MAX_M.items():
        n = 2 * top if second else top
        fits = af.launch_geometry(1, dtype, n, top)["smem_bytes"]
        wider = af.launch_geometry(1, dtype, n + (2 if second else 1), top + 1)
        assert fits <= nvcc_build.SMEM_PER_BLOCK_MAX < wider["smem_bytes"]
        m = top + 1
        Ks, ds, X, U, x0 = _inputs(2, 2 * m if second else m, m, 3, 0, dtype)
        with pytest.raises(ValueError, match=f"m up to {top}"):
            af.affine_family(Ks, ds, X, U, x0, 0.1, second)


def test_wrapper_constants_are_the_sources():
    """The wrapper's lanes a block and ring depth are the ones
    `csrc/affine_family.cu` defines, and its plan of a launch at the bulk
    cell's width: 7 warps of 32 lanes, 3 blocks an SM in float32."""
    src = af.SOURCE.read_text()
    assert int(re.search(r"kLanes = (\d+);", src).group(1)) == af.LANES_PER_BLOCK
    assert int(re.search(r"kStages = (\d+);", src).group(1)) == af.RING_STAGES
    g = af.launch_geometry(294912, torch.float32, 7, 7)
    assert (g["blocks"], g["threads"], g["smem_bytes"]) == (9216, 224, 59136)
    assert g["lanes_per_sm"] == 96


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(LTI))
def test_twin_is_the_old_tensor_path(kind, dtype):
    """The twin gives the bits of the fleet's tensor loop before the kernel,
    on a backward sweep's gains of each LTI kind, in both types."""
    cc, args = _solve_inputs(kind, DTYPES[dtype])
    assert (cc.n, cc.m) == LTI[kind]
    got = af.affine_family_reference(*args, cc.dt, cc.nb_deriv == 2)
    want = _old_affine_family(cc, *args)
    for name, g, w in zip(NAMES, got, want):
        assert _same_bits(g, w), name


@pytest.mark.parametrize("kind", sorted(LTI))
def test_call_site_keeps_the_twin_on_the_cpu(kind, monkeypatch):
    """`_affine_family` runs the twin for CPU tensors, never the wrapper,
    and returns its bits."""
    cc, args = _solve_inputs(kind, torch.float64)

    def kernel(*a):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(fleet, "affine_family", kernel)
    got = fleet._affine_family(cc, *args)
    want = af.affine_family_reference(*args, cc.dt, cc.nb_deriv == 2)
    for name, g, w in zip(NAMES, got, want):
        assert _same_bits(g, w), name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(LTI))
def test_fleet_solve_equals_the_old_path(kind, dtype, monkeypatch):
    """A whole fleet solve on the CPU gives the bits of the same solve with
    the old tensor loop patched in for `_affine_family`: X, U, cost,
    alpha and iterations; no launch is counted."""
    spec = _spec(kind, DTYPES[dtype])
    x0s, U0s = _batch(spec, 6, seed=3)
    nb_iter = 4 if spec.horizon == 100 else 6
    with monkeypatch.context() as m:
        m.setattr(fleet, "_affine_family", _old_affine_family)
        old = fleet.make_fleet_solver(spec, nb_iter)(x0s, U0s)
    before = af.LAUNCHES
    new = fleet.make_fleet_solver(spec, nb_iter)(x0s, U0s)
    assert af.LAUNCHES == before
    for name in ("X", "U", "cost", "alpha", "iterations"):
        assert _same_bits(getattr(new, name), getattr(old, name)), name
    assert bool((new.iterations > 1).any())


# ---------------------------------------------------------------------------
# the kernel against its twin, on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _max_err(got, want):
    return [float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)]


# (n, m, H-1, B): the bulk cell's width at a ragged batch, the double
# integrator, the planar arm below one block's lanes, one lane, a 6-DoF
# chain, one joint of each kind
CASES = [(7, 7, 99, 4133), (14, 7, 60, 300), (3, 3, 99, 33), (7, 7, 12, 1),
         (6, 6, 20, 31), (1, 1, 5, 40), (2, 1, 5, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "n{}_m{}_h{}_b{}".format(*c))
def test_kernel_matches_twin_on_card(case):
    """float64: every output within 1e-12 of the twin's, relative to its
    largest entry; float32: every output's error against the float64 twin
    at most twice the float32 twin's own, plus 1e-6 of its largest entry;
    row 0 is x0 and 0 exactly; one launch a call."""
    _need_card()
    n, m, Hm1, B = case
    second = n != m
    a64 = _inputs(Hm1, n, m, B, seed=n * 1000 + B, device="cuda")
    truth = af.affine_family_reference(*a64, 0.1, second)
    scale = [float(t.abs().max()) for t in truth]
    before = af.LAUNCHES
    got = af.affine_family(*a64, 0.1, second)
    torch.cuda.synchronize()
    assert af.LAUNCHES == before + 1
    for name, e, s in zip(NAMES, _max_err(got, truth), scale):
        assert e <= 1e-12 * s, (name, e, s)
    a32 = [t.float() for t in a64]
    got32 = af.affine_family(*a32, 0.1, second)
    twin32 = af.affine_family_reference(*a32, 0.1, second)
    torch.cuda.synchronize()
    for name, e_k, e_t, s in zip(NAMES, _max_err(got32, truth),
                                 _max_err(twin32, truth), scale):
        assert e_k <= 2 * e_t + 1e-6 * s, (name, e_k, e_t, s)
    for g in (got, got32):
        assert torch.equal(g[0][0], a64[4].to(g[0].dtype))
        assert not bool(g[1][0].any())


@pytest.mark.cuda
def test_wrapper_raises_on_card_tensors_it_cannot_take():
    """On the card too: a float16 call, rows that are not contiguous and
    arrays on two devices raise before any launch."""
    _need_card()
    Ks, ds, X, U, x0 = _inputs(4, 7, 7, 8, 0, torch.float32, "cuda")
    bad = [((Ks.half(), ds.half(), X.half(), U.half(), x0.half()), TypeError),
           ((Ks, ds, X.transpose(1, 2).contiguous().transpose(1, 2), U, x0),
            ValueError),
           ((Ks, ds, X, U, x0.cpu()), ValueError)]
    before = af.LAUNCHES
    for args, err in bad:
        with pytest.raises(err):
            af.affine_family(*args, 0.1, False)
    assert af.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LTI) + ["timeopt"])
def test_solve_launches_once_an_iteration_or_never(kind):
    """A float32 fleet solve on the card: every LTI kind launches the
    kernel once an iteration (one family a line search); the time-optimal
    kind, whose trials re-roll, never."""
    _need_card()
    spec = _spec(kind, torch.float32, "cuda")
    x0s, U0s = _batch(spec, 256, seed=5)
    before = af.LAUNCHES
    res = fleet.make_fleet_solver(spec, 5)(x0s, U0s)
    torch.cuda.synchronize()
    want = int(res.iterations.max()) if kind in LTI else 0
    assert af.LAUNCHES - before == want
    assert bool(torch.isfinite(res.cost).all())


@pytest.mark.cuda
def test_posorn_solve_with_the_kernel_matches_the_twin():
    """One whole posorn fleet solve (H=100, 512 lanes, 10 iterations) on
    the card with the kernel against the same solve with the twin patched
    in: float64, the same iterations and alpha on every lane and every
    cost within 1e-8 relative; float32, every cost finite and the median
    cost within 1% of the twin solve's (float32 rounding flips single
    lanes' alpha and early stop either way)."""
    _need_card()
    for dtype in (torch.float64, torch.float32):
        spec = _spec("posorn", dtype, "cuda")
        x0s, U0s = _batch(spec, 512, seed=7)
        before = af.LAUNCHES
        got = fleet.make_fleet_solver(spec, 10)(x0s, U0s)
        torch.cuda.synchronize()
        assert af.LAUNCHES - before == int(got.iterations.max())
        fleet.affine_family = af.affine_family_reference
        try:
            want = fleet.make_fleet_solver(spec, 10)(x0s, U0s)
        finally:
            fleet.affine_family = af.affine_family
        rel = (got.cost.double() - want.cost.double()).abs() / want.cost.double().abs()
        if dtype == torch.float64:
            assert torch.equal(got.iterations, want.iterations)
            assert torch.equal(got.alpha, want.alpha)
            assert float(rel.max()) <= 1e-8, float(rel.max())
        else:
            assert bool(torch.isfinite(got.cost).all())
            med_g, med_w = float(got.cost.median()), float(want.cost.median())
            assert abs(med_g - med_w) <= 0.01 * med_w, (med_g, med_w)
