import numpy as np
import jax.numpy as jnp
import pytest
from scipy import ndimage

from mad_tpu.ops.convolve import (conv1d_along, gaussian_filter3d,
                                  gaussian_kernel1d, log_filter3d, upsample2)


def test_gaussian_kernel_matches_scipy():
    from scipy.ndimage._filters import _gaussian_kernel1d
    for sigma, order in [(1.0, 0), (2.0, 0), (2.0, 2), (1.5, 2)]:
        radius = int(4.0 * sigma + 0.5)
        ref = _gaussian_kernel1d(sigma, order, radius)[::-1]
        got = gaussian_kernel1d(sigma, order)
        np.testing.assert_allclose(got, ref, atol=1e-7)


def test_conv1d_same_matches_numpy():
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(6, 5, 8)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    out = np.asarray(conv1d_along(jnp.asarray(vol), k, axis=2))
    ref = np.stack([
        np.stack([np.convolve(vol[i, j], k, mode="same")
                  for j in range(5)]) for i in range(6)])
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_conv1d_full_grows():
    vol = jnp.ones((3, 3, 4), dtype=jnp.float32)
    k = np.ones(5, dtype=np.float32)
    out = conv1d_along(vol, k, axis=2, mode="full")
    assert out.shape == (3, 3, 8)


def test_gaussian_filter3d_matches_scipy_interior():
    rng = np.random.default_rng(1)
    vol = np.zeros((24, 24, 24), dtype=np.float32)
    vol[8:16, 8:16, 8:16] = rng.normal(size=(8, 8, 8))
    got = np.asarray(gaussian_filter3d(jnp.asarray(vol), 2.0))
    ref = ndimage.gaussian_filter(vol, 2.0)
    # zero-padding vs reflect differs only near borders; data is interior
    np.testing.assert_allclose(got[4:-4, 4:-4, 4:-4],
                               ref[4:-4, 4:-4, 4:-4], atol=1e-4)


def test_log_filter_matches_scipy_interior():
    rng = np.random.default_rng(2)
    vol = np.zeros((28, 28, 28), dtype=np.float32)
    vol[10:18, 10:18, 10:18] = np.abs(rng.normal(size=(8, 8, 8)))
    sigma = 2.0
    log_got, gauss_got = log_filter3d(jnp.asarray(vol), sigma)
    ref = -ndimage.gaussian_laplace(vol, sigma) * sigma ** 2
    ref[ref < 0] = 0
    np.testing.assert_allclose(np.asarray(log_got)[6:-6, 6:-6, 6:-6],
                               ref[6:-6, 6:-6, 6:-6], atol=1e-4)
    refg = ndimage.gaussian_filter(vol, sigma)
    np.testing.assert_allclose(np.asarray(gauss_got)[6:-6, 6:-6, 6:-6],
                               refg[6:-6, 6:-6, 6:-6], atol=1e-4)


def _catmull_rom_up_ref(x: np.ndarray, axis: int) -> np.ndarray:
    """float64 x2 upsampling along one axis: originals on even samples,
    Catmull-Rom half samples (edge-replicated) on odd ones."""
    x = np.moveaxis(x.astype(np.float64), axis, -1)
    n = x.shape[-1]
    i = np.arange(n - 1)
    at = lambda j: x[..., np.clip(j, 0, n - 1)]
    half = (-at(i - 1) + 9 * at(i) + 9 * at(i + 1) - at(i + 2)) / 16.0
    out = np.zeros(x.shape[:-1] + (2 * n - 1,))
    out[..., 0::2] = x
    out[..., 1::2] = half
    return np.moveaxis(out, -1, axis)


@pytest.mark.parametrize("op,mode,n,ksz,axis", [
    ("conv", "same", 8, 3, 2),
    ("conv", "same", 64, 17, 0),      # wide kernel, even n
    ("conv", "same", 71, 9, 1),       # wide kernel, odd n
    ("conv", "same", 66, 8, 2),       # even tap count
    ("conv", "full", 9, 5, 1),
    ("conv", "full", 64, 7, 2),
    ("conv", "full", 97, 17, 0),
    ("up", None, 64, None, 0),
    ("up", None, 67, None, 1),
    ("up", None, 9, None, 2),
])
def test_separable_ops_match_float64_reference(op, mode, n, ksz, axis):
    """conv1d_along against scipy.ndimage.correlate1d (with the kernel
    reversed, zero boundary) and upsample2 against a float64 Catmull-Rom
    reference, at the widths and tap counts the describe stage uses."""
    rng = np.random.default_rng(n * 31 + axis)
    shape = [5, 6, 7]
    shape[axis] = n
    vol = rng.normal(size=shape).astype(np.float32)
    if op == "conv":
        k = rng.normal(size=ksz).astype(np.float32)
        got = np.asarray(conv1d_along(jnp.asarray(vol), k, axis, mode=mode))
        w = k[::-1].astype(np.float64)
        x = vol.astype(np.float64)
        if mode == "same":
            ref = ndimage.correlate1d(x, w, axis=axis, mode="constant")
        else:
            pad = [(0, 0)] * 3
            pad[axis] = (ksz - 1, ksz - 1)
            full = ndimage.correlate1d(np.pad(x, pad), w, axis=axis,
                                       mode="constant")
            ref = np.take(full, np.arange(n + ksz - 1) + ksz // 2, axis=axis)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        got = np.asarray(upsample2(jnp.asarray(vol)))
        ref = vol.astype(np.float64)
        for a in range(3):
            ref = _catmull_rom_up_ref(ref, a)
        assert got.shape == tuple(2 * s - 1 for s in shape)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_upsample2_shape_and_exactness():
    # Linear ramps are reproduced exactly by Catmull-Rom; original samples kept.
    x, y, z = np.meshgrid(np.arange(6.0), np.arange(5.0), np.arange(7.0),
                          indexing="ij")
    vol = (2 * x + 3 * y - z).astype(np.float32)
    up = np.asarray(upsample2(jnp.asarray(vol)))
    assert up.shape == (11, 9, 13)
    np.testing.assert_allclose(up[::2, ::2, ::2], vol, atol=1e-5)
    interior = up[2:-2, 2:-2, 2:-2]
    xx, yy, zz = np.meshgrid(np.arange(11.0), np.arange(9.0),
                             np.arange(13.0), indexing="ij")
    ref = (xx + 1.5 * yy - 0.5 * zz)[2:-2, 2:-2, 2:-2]
    np.testing.assert_allclose(interior, ref, atol=1e-4)
