"""Separable 1D convolution helpers for 3D volumes (XLA-native).

All volume filtering in the pipeline (Gaussian smoothing, scale-normalized
LoG, density-simulation blur, x2 upsampling) reduces to 1D convolutions along
each axis, written as shift-and-add over the kernel taps: XLA fuses each
axis into one memory-bound loop. Kernels are built host-side with numpy
(tiny) and closed over by jitted callers.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def gaussian_kernel1d(sigma: float, order: int = 0, truncate: float = 4.0
                      ) -> np.ndarray:
    """Gaussian (or Gaussian-derivative) kernel, scipy-compatible.

    Mirrors scipy.ndimage's kernel (radius = int(truncate*sigma + 0.5),
    order-n kernel = Hermite-polynomial times normalized Gaussian) so the
    scale space matches the reference's gaussian_filter / gaussian_laplace
    (mad/MapSpace.py:171,182) to numerical precision.
    """
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) ** 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi /= phi.sum()
    if order == 0:
        return phi.astype(np.float32)
    # polynomial recurrence for the order-th derivative (scipy-equivalent)
    expo = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(expo[1:], 1)
    P = np.diag(np.ones(order) / -sigma2, -1)
    for _ in range(order):
        q = (D + P).dot(q)
    q = (x[:, None] ** expo).dot(q)
    return (q * phi).astype(np.float32)


def conv1d_along(vol: jnp.ndarray, kernel: np.ndarray, axis: int,
                 mode: str = "same") -> jnp.ndarray:
    """Convolve a 3D volume with a 1D kernel along one axis.

    mode: 'same' (zero-padded, output size preserved) or 'full'
    (output grows by len(kernel)-1, matching scipy.signal.convolve 'full').

    The slice-weighted sum over the taps fuses into one loop per call that
    reads each voxel once and writes it once.
    """
    k = np.asarray(kernel)
    ksz = k.shape[0]
    r = ksz // 2
    if mode == "same":
        lo, hi = r, ksz - 1 - r
        out_n = vol.shape[axis]
    elif mode == "full":
        lo = hi = ksz - 1
        out_n = vol.shape[axis] + ksz - 1
    else:
        raise ValueError(mode)
    pad = [(0, 0)] * vol.ndim
    pad[axis] = (lo, hi)
    padded = jnp.pad(vol, pad)
    out = None
    for m in range(ksz):
        w = float(k[ksz - 1 - m])
        if w == 0.0:
            continue
        idx = [slice(None)] * vol.ndim
        idx[axis] = slice(m, m + out_n)
        term = w * padded[tuple(idx)]
        out = term if out is None else out + term
    return out


def separable_conv3d(vol: jnp.ndarray, kernels, mode: str = "same"
                     ) -> jnp.ndarray:
    """Apply (kx, ky, kz) 1D kernels along axes 0, 1, 2."""
    out = vol
    for axis, kern in enumerate(kernels):
        out = conv1d_along(out, kern, axis, mode=mode)
    return out


def gaussian_filter3d(vol: jnp.ndarray, sigma: float, truncate: float = 4.0
                      ) -> jnp.ndarray:
    """Separable Gaussian smoothing (zero boundary; the pipeline zero-pads
    maps before filtering so this matches scipy's 'reflect' on real data)."""
    k = gaussian_kernel1d(sigma, 0, truncate)
    return separable_conv3d(vol, (k, k, k))


def log_filter3d(vol: jnp.ndarray, sigma: float, truncate: float = 4.0):
    """Scale-normalized negative LoG plus the plain Gaussian, sharing passes.

    Returns (log_response, gauss) where
      log_response = max(0, -sigma^2 * laplacian_of_gaussian(vol))
    (parity: mad/MapSpace.py:169-182). The Gaussian-smoothed volume reuses
    two of the three separable passes.
    """
    g0 = gaussian_kernel1d(sigma, 0, truncate)
    g2 = gaussian_kernel1d(sigma, 2, truncate)
    ax = conv1d_along(vol, g0, 0)
    axy = conv1d_along(ax, g0, 1)
    gauss = conv1d_along(axy, g0, 2)
    term_z = conv1d_along(axy, g2, 2)
    term_y = conv1d_along(conv1d_along(ax, g2, 1), g0, 2)
    term_x = conv1d_along(conv1d_along(conv1d_along(vol, g2, 0), g0, 1), g0, 2)
    lap = term_x + term_y + term_z
    log_resp = jnp.maximum(-lap * (sigma ** 2), 0.0)
    return log_resp, gauss


# Catmull-Rom weights for the half-sample points of a x2 upsampling.
_CR_HALF = np.array([-1.0 / 16, 9.0 / 16, 9.0 / 16, -1.0 / 16],
                    dtype=np.float32)


def _upsample_axis(vol: jnp.ndarray, axis: int) -> jnp.ndarray:
    """x2 upsample along one axis: size n -> 2n-1 (original samples kept,
    half-samples by Catmull-Rom; replaces the reference's per-axis cubic
    spline, mad/MapSpace.py:191-214)."""
    moved = jnp.moveaxis(vol, axis, -1)
    n = moved.shape[-1]
    padded = jnp.concatenate(
        [moved[..., :1], moved, moved[..., -1:]], axis=-1
    )  # replicate edges
    # valid conv over n+2 with the 4-tap kernel -> n-1 half samples
    # (shift-and-add, see conv1d_along)
    out = None
    for m in range(4):
        term = float(_CR_HALF[3 - m]) * padded[..., m: m + n - 1]
        out = term if out is None else out + term
    inter = jnp.zeros(moved.shape[:-1] + (2 * n - 1,), dtype=vol.dtype)
    inter = inter.at[..., 0::2].set(moved)
    inter = inter.at[..., 1::2].set(out)
    return jnp.moveaxis(inter, -1, axis)


def upsample2(vol: jnp.ndarray) -> jnp.ndarray:
    """Separable x2 cubic upsampling: (X,Y,Z) -> (2X-1, 2Y-1, 2Z-1)."""
    out = vol
    for axis in range(3):
        out = _upsample_axis(out, axis)
    return out
