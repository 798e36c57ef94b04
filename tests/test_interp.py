"""Trilinear gathers of the rigid refiner: the corner-packed layout equals
the 8-gather form, and both match a float64 host reference."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.interpolate import RegularGridInterpolator

from mad_tpu.ops.interp import pack_corners, trilinear, trilinear_packed


def _field_and_points(shape, n_pts, seed):
    rng = np.random.default_rng(seed)
    field = rng.normal(size=shape + (3,)).astype(np.float32)
    hi = np.asarray(shape, np.float64) - 1.0
    pts = rng.uniform(-0.5, hi + 0.5, size=(n_pts, 3)).astype(np.float32)
    return field, pts


@pytest.mark.parametrize("shape,n_pts,seed", [
    ((7, 6, 5), 64, 0),
    ((16, 17, 9), 300, 1),
    ((33, 8, 21), 500, 2),
])
def test_trilinear_matches_host_reference(shape, n_pts, seed):
    field, pts = _field_and_points(shape, n_pts, seed)
    got = np.asarray(trilinear(jnp.asarray(field), jnp.asarray(pts)))
    axes = [np.arange(s, dtype=np.float64) for s in shape]
    clipped = np.clip(pts.astype(np.float64), 0.0,
                      np.asarray(shape, np.float64) - 1)
    ref = RegularGridInterpolator(axes, field.astype(np.float64))(clipped)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((16, 17, 9), None),
    ((33, 8, 21), None),
    ((12, 10, 14), "bfloat16"),
])
def test_trilinear_packed_equals_trilinear(shape, dtype):
    field, pts = _field_and_points(shape, 400, 7)
    f = jnp.asarray(field)
    packed = pack_corners(f, dtype)
    assert packed.shape == ((shape[0] - 1) * (shape[1] - 1)
                            * (shape[2] - 1), 32)
    got = np.asarray(trilinear_packed(packed, shape, jnp.asarray(pts)))
    if dtype is None:
        want = np.asarray(trilinear(f, jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        rounded = f.astype(dtype).astype(jnp.float32)
        want = np.asarray(trilinear(rounded, jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, atol=1e-5)
