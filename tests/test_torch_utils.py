"""Port parity, the host utilities: `ilqr_planner_torch.utils` (metrics and
tracing, checkpoints, CSV and matrix-list files), `ops/kinutils.py` and the
native URDF parser `models/native.py`, against the JAX package's, float64
on the CPU.

Checkpoints and files cross between the packages: each reads what the
other wrote (dicts, lists and tuples of arrays; a structure mismatch
raises). `jac_pseudo_inverse` at 1e-12; the native parser against the
port's Python parser bit for bit, and `chain_from_urdf(prefer_native=)`
against the JAX package's bit for bit.
"""

import collections
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, chain_from_urdf, native
from ilqr_planner_torch.models.urdf import parse_urdf
from ilqr_planner_torch.ops.kinutils import jac_pseudo_inverse
from ilqr_planner_torch.solvers.ilqr import ILQRResult
from ilqr_planner_torch.utils import (MetricsCallback, load_checkpoint,
                                      load_csv, load_matrix_list,
                                      save_checkpoint, save_csv,
                                      save_matrix_list, trace)
from ilqr_planner_torch.utils.callbacks import progress_message


def test_metrics_callback_matches_jax():
    from ilqr_planner_tpu.utils import MetricsCallback as JMetrics

    msgs = [progress_message(1, 0.21419412, 1.0),
            progress_message(8, 9.80376e-07, 2.0 ** -10),
            progress_message(3, float("nan"), 0.5), "not a progress line"]
    got, want = MetricsCallback(), JMetrics()
    for m in msgs:
        got.notify(m)
        want.notify(m)
    keys = [sorted(r) for r in got.records]
    assert keys == [sorted(r) for r in want.records]
    assert [r.get("iteration") for r in got.records] == \
        [r.get("iteration") for r in want.records] == [1, 8, 3, None]
    assert got.costs[:2] == want.costs[:2] == [0.214194, 9.80376e-07]
    assert np.isnan(got.costs[2]) and np.isnan(want.costs[2])
    assert got.alphas == want.alphas
    assert got.records[3]["raw"] == "not a progress line"
    assert all(r["wall_time"] >= 0 for r in got.records)


def test_trace_timer_and_profile(tmp_path, capsys):
    """trace(None) prints the elapsed wall time; trace(logdir) writes a
    torch.profiler Chrome trace that holds the traced ops."""
    with trace():
        torch.ones(3).sum()
    out = capsys.readouterr().out
    assert out.startswith("[trace] ") and out.strip().endswith("s")
    logdir = tmp_path / "tb"
    with trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = (logdir / "trace.json").read_text()
    assert "traceEvents" in text and "aten::mm" in text


Pair = collections.namedtuple("Pair", ["lo", "hi"])


@dataclasses.dataclass
class Lanes:
    u: torch.Tensor
    meta: dict


def _state(seed=0):
    """A nest of dicts, lists and tuples of float64 arrays."""
    rng = np.random.default_rng(seed)
    return {"U": rng.normal(size=(4, 3)), "lam": [rng.normal(size=5),
                                                  rng.normal(size=(2, 2))],
            "alpha": (np.float64(0.5), rng.normal(size=2)),
            "step": np.int64(7)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.as_tensor(tree)


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_checkpoint_round_trip_in_the_port(tmp_path):
    """Dicts, lists, tuples, namedtuples and the port's dataclass results
    (None fields are empty nodes); leaves come back as tensors on the
    device and in the dtype of `like`'s leaves."""
    state = {"res": ILQRResult(*(torch.randn(3) for _ in range(8))),
             "pair": Pair(torch.arange(4), [torch.ones(2, dtype=torch.float32)]),
             "lanes": Lanes(torch.randn(2, 5), {"b": torch.zeros(1), "a": 3.0})}
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, state)
    like = {"res": ILQRResult(*(torch.zeros(3) for _ in range(8))),
            "pair": Pair(torch.zeros(4, dtype=torch.float64),
                         [torch.zeros(2, dtype=torch.float32)]),
            "lanes": Lanes(torch.zeros(2, 5), {"b": torch.zeros(1),
                                               "a": torch.zeros(())})}
    got = load_checkpoint(path, like)
    assert isinstance(got["res"], ILQRResult) and got["res"].progress is None
    assert isinstance(got["pair"], Pair) and isinstance(got["lanes"], Lanes)
    assert got["pair"].lo.dtype == torch.float64      # like's dtype
    assert got["pair"].hi[0].dtype == torch.float32
    torch.testing.assert_close(got["res"].X, state["res"].X, rtol=0, atol=0)
    torch.testing.assert_close(got["pair"].lo, state["pair"].lo.double())
    torch.testing.assert_close(got["lanes"].meta["a"], torch.tensor(3.0))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_the_packages(tmp_path, writer):
    """A checkpoint of dicts, lists and tuples of arrays written by one
    package loads in the other, the same arrays in the same places; the
    stored key paths are the same."""
    from ilqr_planner_tpu.utils import checkpoint as jckpt

    state = _state()
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        save_checkpoint(path, _as_torch(state))
        got = jckpt.load_checkpoint(path, state)
    else:
        jckpt.save_checkpoint(path, state)
        got = load_checkpoint(path, _as_torch(state))
        assert all(isinstance(x, torch.Tensor) for x in
                   (got["U"], got["lam"][0], got["alpha"][0], got["step"]))
    _equal(got, state)
    other = str(tmp_path / "other.npz")
    (jckpt.save_checkpoint(other, state) if writer == "port"
     else save_checkpoint(other, _as_torch(state)))
    with np.load(path) as a, np.load(other) as b:
        assert bytes(a["__paths__"]) == bytes(b["__paths__"])


def test_checkpoint_structure_mismatch_raises(tmp_path):
    from ilqr_planner_tpu.utils import checkpoint as jckpt

    path = str(tmp_path / "s.npz")
    save_checkpoint(path, _as_torch(_state()))
    wrong = _as_torch(_state())
    wrong["lam"] = wrong["lam"][:1]
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(path, wrong)
    renamed = _as_torch(_state())
    renamed["V"] = renamed.pop("U")
    with pytest.raises(ValueError, match="leaf key paths differ"):
        load_checkpoint(path, renamed)
    jwrong = _state()
    jwrong["alpha"] = list(jwrong["alpha"])[:1]
    with pytest.raises(ValueError, match="structure mismatch"):
        jckpt.load_checkpoint(path, jwrong)


def test_csv_files_cross_the_packages(tmp_path):
    """save_csv of a tensor, a list of tensors and an array: byte for byte
    the JAX package's file, and each package loads the other's."""
    from ilqr_planner_tpu.utils import serialize as jser

    rng = np.random.default_rng(1)
    U = rng.normal(size=(6, 7))
    for rows in (torch.as_tensor(U), [torch.as_tensor(r) for r in U], U[:, 0]):
        mine, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
        assert save_csv(rows, str(mine))
        ref = U[:, 0] if isinstance(rows, np.ndarray) else U
        jser.save_csv(ref, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes()
        np.testing.assert_array_equal(jser.load_csv(str(mine)),
                                      load_csv(str(theirs)))
    # one column reads back as one row, as in the JAX package
    np.testing.assert_array_equal(load_csv(str(tmp_path / "port.csv")),
                                  U[None, :, 0])


def test_matrix_list_files_cross_the_packages(tmp_path):
    from ilqr_planner_tpu.utils import serialize as jser

    rng = np.random.default_rng(2)
    mats = [rng.normal(size=(7, 7)), rng.normal(size=(3, 2)), rng.normal(size=4)]
    mine, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert save_matrix_list([torch.as_tensor(m) for m in mats], str(mine))
    jser.save_matrix_list(mats, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    for got, want in zip(load_matrix_list(str(theirs)),
                         jser.load_matrix_list(str(mine))):
        np.testing.assert_array_equal(got, want)
    assert [m.shape for m in load_matrix_list(str(mine))] == [(7, 7), (3, 2),
                                                              (1, 4)]


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_jac_pseudo_inverse_matches_jax(weighted):
    """Batched Jacobians [2, 3, 6, 7] and an SPD inverse mass matrix,
    against the JAX function at 1e-12; J J+ = I."""
    from ilqr_planner_tpu.ops.kinutils import jac_pseudo_inverse as jpinv

    rng = np.random.default_rng(3)
    J = rng.normal(size=(2, 3, 6, 7))
    M = rng.normal(size=(7, 7))
    Minv = M @ M.T + 7 * np.eye(7) if weighted else None
    got = jac_pseudo_inverse(torch.as_tensor(J),
                             None if Minv is None else torch.as_tensor(Minv))
    want = np.asarray(jpinv(J, Minv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    np.testing.assert_allclose((torch.as_tensor(J) @ got).numpy(),
                               np.broadcast_to(np.eye(6), (2, 3, 6, 6)),
                               atol=1e-12)


@pytest.fixture(scope="module")
def native_lib():
    missing = [t for t in ("make", "g++") if shutil.which(t) is None]
    if missing:
        pytest.skip(f"{' and '.join(missing)} missing: the native URDF "
                    "library cannot be built")
    assert native.available() or native.build(), "make -C native failed"


@pytest.mark.parametrize("is_path", [True, False], ids=["path", "text"])
def test_native_parser_matches_python_parser(native_lib, is_path):
    """The native extractor's joints equal the Python parser's (a
    continuous joint reads as revolute) and the JAX package's native
    parse."""
    from ilqr_planner_tpu.models import native as jnative

    urdf = str(PANDA_URDF) if is_path else PANDA_URDF.read_text()
    py = parse_urdf(urdf, "panda_link0", "panda_tip", is_path=is_path)
    nat = native.parse_urdf_native(urdf, "panda_link0", "panda_tip",
                                   is_path=is_path)
    assert len(py) == len(nat) == 10
    for a, b in zip(py, nat):
        assert a["type"] == b["type"] or (a["type"], b["type"]) == (
            "continuous", "revolute")
        for k in ("R", "p", "axis"):
            np.testing.assert_array_equal(a[k], b[k])
    if jnative.available():
        for a, b in zip(jnative.parse_urdf_native(urdf, "panda_link0",
                                                  "panda_tip", is_path=is_path),
                        nat):
            assert a["type"] == b["type"]
            for k in ("R", "p", "axis"):
                np.testing.assert_array_equal(a[k], b[k])


def test_native_parser_errors(native_lib):
    with pytest.raises(ValueError, match="Unable to build kinematic chain"):
        native.parse_urdf_native(str(PANDA_URDF), "panda_link0", "no_such_link")
    with pytest.raises(ValueError, match="Unable to read URDF"):
        native.parse_urdf_native("/nonexistent/robot.urdf", "a", "b")


@pytest.mark.parametrize("is_path", [True, False], ids=["path", "text"])
def test_chain_from_urdf_prefer_native_matches_jax(native_lib, monkeypatch,
                                                   is_path):
    """chain_from_urdf(prefer_native=) parses with the native extractor
    when it is built and with the Python parser otherwise, as the JAX
    package's does: the Panda chain through both parsers and both packages
    is the same, bit for bit."""
    from ilqr_planner_tpu.models import chain_from_urdf as jchain_from_urdf
    from ilqr_planner_tpu.models import native as jnative

    assert jnative.available()
    urdf = str(PANDA_URDF) if is_path else PANDA_URDF.read_text()
    calls = []
    parse = native.parse_urdf_native
    monkeypatch.setattr(native, "parse_urdf_native",
                        lambda *a, **k: calls.append(a) or parse(*a, **k))
    chains = {}
    for prefer in (True, False):
        chains[prefer] = chain_from_urdf(urdf, "panda_link0", "panda_tip",
                                         is_path=is_path, device="cpu",
                                         prefer_native=prefer)
        assert len(calls) == 1
        ref = jchain_from_urdf(urdf, "panda_link0", "panda_tip",
                               is_path=is_path, dtype=np.float64,
                               prefer_native=prefer)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(
                getattr(chains[prefer], f.name).numpy(),
                np.asarray(getattr(ref, f.name)), err_msg=f.name)
    for f in dataclasses.fields(chains[True]):
        assert torch.equal(getattr(chains[True], f.name),
                           getattr(chains[False], f.name)), f.name
    monkeypatch.setattr(native, "available", lambda: False)
    chain_from_urdf(urdf, "panda_link0", "panda_tip", is_path=is_path,
                    device="cpu")
    assert len(calls) == 1
