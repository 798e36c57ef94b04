"""Card-only checks of the choices made for the GPU (marker ``gpu``).

They skip on the CPU; run them on a GPU host with
``MAD_TPU_GPU_TESTS=1 python -m pytest tests/ -m gpu``. chip_smoke.py
repeats them at the bench's real widths.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_similarity_precision_is_float32_on_card(gpu):
    """The descriptor-cosine matmul compiles at the precision the matcher
    names and stays within 1e-4 of float64 (single-pass TF32 does not)."""
    import jax
    import jax.numpy as jnp
    from mad_tpu.engine import match

    rng = np.random.default_rng(0)
    hi = np.abs(rng.normal(size=(384, 1024))).astype(np.float32)
    lo = np.abs(rng.normal(size=(2048, 1024))).astype(np.float32)
    hi /= np.linalg.norm(hi, axis=1, keepdims=True)
    lo /= np.linalg.norm(lo, axis=1, keepdims=True)
    fn = jax.jit(lambda a, b: jnp.dot(
        a, b.T, precision=match.SIMILARITY_PRECISION,
        preferred_element_type=jnp.float32))
    got = np.asarray(jax.device_put(fn(hi, lo), gpu), np.float64)
    ref = hi.astype(np.float64) @ lo.astype(np.float64).T
    assert np.max(np.abs(got - ref)) <= 1e-4
    assert '"HIGHEST"' in fn.lower(hi, lo).compile().as_text()


def test_log_filter_on_card_matches_scipy(gpu):
    import jax.numpy as jnp
    from scipy import ndimage
    from mad_tpu.ops.convolve import log_filter3d

    rng = np.random.default_rng(1)
    vol = np.zeros((96, 80, 72), np.float32)
    vol[20:76, 20:60, 20:52] = np.abs(rng.normal(size=(56, 40, 32)))
    got, _ = log_filter3d(jnp.asarray(vol), 2.0)
    ref = -ndimage.gaussian_laplace(vol.astype(np.float64), 2.0) * 4.0
    ref[ref < 0] = 0
    np.testing.assert_allclose(np.asarray(got)[10:-10, 10:-10, 10:-10],
                               ref[10:-10, 10:-10, 10:-10], atol=1e-4)
