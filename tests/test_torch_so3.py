"""Port parity, the SO(3) constructors: `rot_x`, `rot_y`, `rot_z`,
`rpy_matrix`, `euler_zyx` and `cross` of ilqr_planner_torch's `ops/so3.py`
against the JAX package's, float64 on the CPU (1e-15: the two libraries'
sin and cos may round the last bit otherwise); and the URDF parser, which
builds its joint rotations with `so3.rpy_matrix`, giving the Panda chains
of its former numpy rotation bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilqr_planner_torch.models import PANDA_URDF, chain_from_urdf, urdf
from ilqr_planner_torch.ops import so3


def _angles(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, shape)


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z"])
def test_axis_rotations_match_jax(name):
    """One matrix a scalar angle, as the JAX functions take; a batch of
    angles gives the stacked matrices."""
    from ilqr_planner_tpu.ops import so3 as jso3

    a = _angles(6, 1)
    got = getattr(so3, name)(torch.tensor(a))
    assert got.shape == (6, 3, 3)
    for i, ai in enumerate(a):
        want = np.asarray(getattr(jso3, name)(ai))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-15, rtol=0)
        one = getattr(so3, name)(torch.tensor(ai))
        assert one.shape == (3, 3) and torch.equal(one, got[i])


@pytest.mark.parametrize("name", ["rpy_matrix", "euler_zyx"])
def test_composed_rotations_match_jax(name):
    from ilqr_planner_tpu.ops import so3 as jso3

    for r, p, y in _angles((8, 3), 2):
        got = getattr(so3, name)(*(torch.tensor(v) for v in (r, p, y)))
        want = np.asarray(getattr(jso3, name)(r, p, y))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-15, rtol=0)
        np.testing.assert_allclose(got.numpy() @ got.numpy().T, np.eye(3),
                                   atol=1e-15)


def test_cross_matches_jax_and_broadcasts():
    from ilqr_planner_tpu.ops import so3 as jso3

    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(4, 1, 3)), rng.normal(size=(5, 3))
    got = so3.cross(torch.tensor(a), torch.tensor(b))
    assert got.shape == (4, 5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jso3.cross(a, b)),
                               atol=1e-15, rtol=0)


def _numpy_rpy(r, p, y):
    """The parser's former rotation: numpy's Rz(y) @ Ry(p) @ Rx(r)."""
    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return rz(y) @ ry(p) @ rx(r)


@pytest.mark.parametrize("tip", ["panda_tip", "panda_link6"])
def test_urdf_chain_unchanged_bit_for_bit(tip, monkeypatch):
    """The Panda chains (to the tip and to link 6) parsed with
    `so3.rpy_matrix` equal those of the numpy rotation, bit for bit."""
    now = chain_from_urdf(PANDA_URDF, "panda_link0", tip, device="cpu")
    monkeypatch.setattr(urdf, "_rpy_mat", _numpy_rpy)
    before = chain_from_urdf(PANDA_URDF, "panda_link0", tip, device="cpu")
    for f in dataclasses.fields(now):
        a, b = getattr(now, f.name), getattr(before, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
