"""Port parity, the S^3 manifold operations: every function of
`ilqr_planner_torch.ops.sd` against `ilqr_planner_tpu.ops.sd` on the same
float64 arrays, over random quaternions and the guard cases (an all-zero
base, an all-zero point, coincident points, a negative dot product,
antipodal points, a zero tangent). Tolerance 1e-12 absolute (the same
arithmetic, sums in another order); no value may be NaN or inf. Where two
coincident points come from unit-normed inputs, log_map's arccos of a dot
product one ulp from 1 turns a last-bit difference of the normalization into
up to sqrt(2 * 2^-52) ~ 2.1e-8 (the formula's conditioning, shared by both
packages): such rows are held at that bound.
"""

import numpy as np
import pytest
import torch

from ilqr_planner_torch.ops import sd


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _cases():
    """name -> (base [L, 4], y [L, 4], tangent v [L, 4])."""
    rng = np.random.default_rng(0)
    L = 6
    b = _unit(rng.normal(size=(L, 4)))
    y = _unit(rng.normal(size=(L, 4)))
    v = rng.normal(size=(L, 4)) * 0.3
    zero = np.zeros((L, 4))
    flipped = np.where((b * y).sum(-1, keepdims=True) > 0, -y, y)
    return {
        "random": (b, y, v),
        "raw_norms": (b * 1.7, y * 0.4, v),
        "zero_base": (zero, y, v),
        "zero_point": (b, zero, v),
        "coincident": (b, b.copy(), v),
        "negative_dot": (b, flipped, v),
        "antipodal": (b, -b, v),
        "zero_tangent": (b, y, zero),
        "beyond_one": (b * (1.0 + 1e-9), b.copy(), v),
    }


CASES = _cases()


# log_map's bound on coincident unit-normed points (see the docstring)
COINCIDENT_ATOL = np.sqrt(2 * 2.0 ** -52)


def _pair(name, *arrays):
    """(port, JAX) outputs of `name` on the same arrays: same shape, the
    port's finite."""
    import jax.numpy as jnp

    from ilqr_planner_tpu.ops import sd as jsd

    ref = np.asarray(getattr(jsd, name)(*(jnp.asarray(a) for a in arrays)))
    got = getattr(sd, name)(*(torch.as_tensor(a) for a in arrays)).numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    return got, ref


def _both(name, *arrays):
    got, ref = _pair(name, *arrays)
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_distance_and_log_map_match_jax(case):
    b, y, _ = CASES[case]
    _both("distance", b, y)
    out = _both("log_map", b, y)
    if case in ("zero_base", "zero_point", "coincident"):
        assert not out.any()


@pytest.mark.parametrize("case", list(CASES))
def test_transport_matches_jax(case):
    b, y, v = CASES[case]
    out = _both("transport", v, b, y)
    if case in ("zero_base", "zero_point"):
        np.testing.assert_array_equal(out, v)


@pytest.mark.parametrize("case", list(CASES))
def test_exp_map_and_unit_norm_match_jax(case):
    b, _, v = CASES[case]
    _both("to_unit_norm", b)
    out = _both("exp_map", b, v)
    if case == "zero_tangent":
        np.testing.assert_allclose(out, b, atol=1e-15, rtol=0)


def test_rate_maps_match_jax_with_leading_axes():
    rng = np.random.default_rng(1)
    q = _unit(rng.normal(size=(3, 5, 4)))
    w = rng.normal(size=(3, 5, 3))
    assert _both("dquat_to_dx_jac", q).shape == (3, 5, 3, 4)
    assert _both("quat_rate", q, w).shape == (3, 5, 4)
    # the reversed axis pairs column 2 with itself: coincident points
    y = q[:, ::-1].copy()
    same = (q == y).all(-1)
    assert same[:, 2].all() and same.sum() == 3
    got, ref = _pair("log_map", q, y)
    np.testing.assert_allclose(got[~same], ref[~same], atol=1e-12, rtol=0)
    np.testing.assert_allclose(got[same], ref[same], atol=COINCIDENT_ATOL, rtol=0)
