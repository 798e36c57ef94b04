import numpy as np
import jax.numpy as jnp

from mad_tpu.core.config import DetectConfig
from mad_tpu.ops.detect import detect_anchors


def _blob(shape, center, sigma=2.5, amp=1.0):
    xs = [np.arange(s, dtype=np.float64) for s in shape]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    r2 = ((X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2)
    return amp * np.exp(-r2 / (2 * sigma ** 2))


def test_detects_blob_with_subvoxel_accuracy():
    shape = (40, 40, 40)
    true_c = np.array([20.3, 19.6, 20.1])
    vol = _blob(shape, true_c).astype(np.float32)
    cfg = DetectConfig(max_anchors=16, exclude_border=4)
    a = detect_anchors(jnp.asarray(vol), shape, cfg)
    valid = np.asarray(a.valid)
    assert valid.sum() == 1
    sub = np.asarray(a.subvox)[valid][0]
    np.testing.assert_allclose(sub, true_c, atol=0.15)


def test_threshold_and_border_exclusion():
    shape = (40, 40, 40)
    vol = (_blob(shape, [20, 20, 20], amp=0.04)        # below threshold
           + _blob(shape, [3, 20, 20], amp=1.0))       # in border zone
    cfg = DetectConfig(max_anchors=16, exclude_border=6)
    a = detect_anchors(jnp.asarray(vol.astype(np.float32)), shape, cfg)
    assert np.asarray(a.valid).sum() == 0


def test_two_blobs():
    shape = (48, 40, 40)
    vol = (_blob(shape, [14.2, 20, 20]) + _blob(shape, [33.7, 20, 20]))
    cfg = DetectConfig(max_anchors=16, exclude_border=4)
    a = detect_anchors(jnp.asarray(vol.astype(np.float32)), shape, cfg)
    valid = np.asarray(a.valid)
    assert valid.sum() == 2
    subs = np.sort(np.asarray(a.subvox)[valid][:, 0])
    np.testing.assert_allclose(subs, [14.2, 33.7], atol=0.2)


def test_capacity_keeps_strongest():
    shape = (64, 40, 40)
    vol = sum(_blob(shape, [8 + 6 * i, 20, 20], amp=0.1 + 0.1 * i)
              for i in range(8))
    cfg = DetectConfig(max_anchors=4, exclude_border=4)
    a = detect_anchors(jnp.asarray(np.asarray(vol, np.float32)), shape, cfg)
    vals = np.asarray(a.values)[np.asarray(a.valid)]
    # The 4 retained anchors are the strongest ones
    assert vals.min() > 0.4


def test_collect_peaks_matches_host_reference_above_2_pow_22():
    """Seed collection on an octave larger than 2^22 voxels (the two-stage
    top-k), with more peaks than capacity, returns exactly the host
    reference's index set (scipy 3x3x3 maximum filter + np.argpartition)
    and exactly what one flat lax.top_k returns, order included."""
    import jax
    from scipy import ndimage
    from mad_tpu.ops.detect import collect_peaks

    rng = np.random.default_rng(5)
    shape = (170, 165, 160)                       # 4.49 M voxels > 2^22
    vol = ndimage.gaussian_filter(rng.normal(size=shape), 2.0
                                  ).astype(np.float32)
    real, eb, thr, cap = (166, 163, 158), 12, 0.01, 1024
    fn = jax.jit(collect_peaks, static_argnums=(1, 2, 3, 4))
    vals, idx = (np.asarray(a) for a in fn(jnp.asarray(vol), real, thr,
                                            eb, cap))

    pooled = ndimage.maximum_filter(vol, size=3, mode="constant",
                                    cval=-np.inf)
    x, y, z = np.indices(shape)
    interior = ((x >= eb) & (x < real[0] - eb) & (y >= eb)
                & (y < real[1] - eb) & (z >= eb) & (z < real[2] - eb))
    peak = (vol >= pooled) & (vol > thr) & interior
    assert peak.sum() > cap                       # capacity truncates
    scores = np.where(peak, vol, -np.inf).ravel()
    ref = np.argpartition(-scores, cap - 1)[:cap]
    assert np.all(np.isfinite(vals))
    assert set(idx.tolist()) == set(ref.tolist())
    np.testing.assert_array_equal(vals, scores[idx])
    assert np.all(np.diff(vals) <= 0)             # top_k order
    fvals, fidx = jax.lax.top_k(jnp.asarray(scores, jnp.float32), cap)
    np.testing.assert_array_equal(idx, np.asarray(fidx))
    np.testing.assert_array_equal(vals, np.asarray(fvals))
