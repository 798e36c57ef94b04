"""Rotation / rigid-transform primitives (jit- and vmap-friendly).

Replaces the reference's ``mad/math_utils.py`` (unit_vector :5,
euler_rod_mat :15, get_rototrans_SVD :29) with batched jnp equivalents.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unit(v: jnp.ndarray, eps: float = 1e-30) -> jnp.ndarray:
    """Normalize along the last axis; zero vectors pass through unchanged
    (parity with mad/math_utils.py:5-13 which returns the input on warning)."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.where(n > eps, v / jnp.where(n > eps, n, 1.0), v)


def axis_angle_mat(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Euler-Rodrigues rotation matrix; batched over leading dims.

    Matches the reference sign convention (mad/math_utils.py:15-27): the
    quaternion vector part is ``-axis * sin(angle/2)``, i.e. the returned R
    satisfies ``R @ v`` = rotation of v by ``angle`` about ``axis`` following
    the reference's (transposed-application) convention. Used identically
    everywhere so conventions cancel.
    """
    a = jnp.cos(angle / 2.0)[..., None]
    bcd = -axis * jnp.sin(angle / 2.0)[..., None]
    b, c, d = bcd[..., 0:1], bcd[..., 1:2], bcd[..., 2:3]
    a = a[..., 0:1]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    row0 = jnp.concatenate([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)], -1)
    row1 = jnp.concatenate([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)], -1)
    row2 = jnp.concatenate([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotation_to_pole(v: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix taking unit vector(s) v to +z.

    Mirrors the reference's main-bin alignment (mad/Orientator.py:197-203):
    angle = arccos(v . z), axis = normalize(v x z), Euler-Rodrigues matrix.
    For v at -z the cross product vanishes and the half-turn axis is
    arbitrary; the reference's shipped center table stores the south cap at
    (-7.3e-6, 0, -1) so its cross product resolves numerically to +y — we
    use the same axis so canonical frames (and therefore secondary-bin
    sets) match. For +z the angle is 0 and the axis is irrelevant.
    """
    z = jnp.array([0.0, 0.0, 1.0], dtype=v.dtype)
    angle = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))
    ax = jnp.cross(v, jnp.broadcast_to(z, v.shape))
    n = jnp.linalg.norm(ax, axis=-1, keepdims=True)
    fallback = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dtype=v.dtype), v.shape)
    ax = jnp.where(n > 1e-12, ax / jnp.where(n > 1e-12, n, 1.0), fallback)
    return axis_angle_mat(ax, angle)


def rotation_about_z(angle: jnp.ndarray) -> jnp.ndarray:
    z = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=jnp.result_type(angle, jnp.float32)),
        jnp.shape(angle) + (3,),
    )
    return axis_angle_mat(z, angle)


def kabsch(mobile: jnp.ndarray, reference: jnp.ndarray):
    """Optimal rigid transform: returns (R, T) with reference ~ mobile @ R + T.

    Matches the application convention of mad/math_utils.py:29-53
    (``T = av2 - av1 @ R``, points transform as ``x @ R + T``).
    Batched over leading dims via vmap-compatible ops.
    """
    av1 = jnp.mean(mobile, axis=-2, keepdims=True)
    av2 = jnp.mean(reference, axis=-2, keepdims=True)
    m = mobile - av1
    r = reference - av2
    a = jnp.swapaxes(m, -1, -2) @ r
    u, _, vt = jnp.linalg.svd(a)
    det = jnp.linalg.det(jnp.swapaxes(vt, -1, -2) @ jnp.swapaxes(u, -1, -2))
    flip = jnp.stack(
        [jnp.ones_like(det), jnp.ones_like(det), det], axis=-1
    )[..., :, None]
    vt = vt * flip
    R = jnp.swapaxes(jnp.swapaxes(vt, -1, -2) @ jnp.swapaxes(u, -1, -2), -1, -2)
    T = av2[..., 0, :] - (av1 @ R)[..., 0, :]
    return R, T


def kabsch_np(mobile: "np.ndarray", reference: "np.ndarray"):
    """Host-side twin of :func:`kabsch` (same convention; batched 3x3 SVDs
    are microseconds of numpy, so host callers avoid two device round
    trips)."""
    import numpy as np
    av1 = np.mean(mobile, axis=-2, keepdims=True)
    av2 = np.mean(reference, axis=-2, keepdims=True)
    m = mobile - av1
    r = reference - av2
    a = np.swapaxes(m, -1, -2) @ r
    u, _, vt = np.linalg.svd(a)
    det = np.linalg.det(np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2))
    flip = np.stack(
        [np.ones_like(det), np.ones_like(det), det], axis=-1
    )[..., :, None]
    vt = vt * flip
    R = np.swapaxes(np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2), -1, -2)
    T = av2[..., 0, :] - (av1 @ R)[..., 0, :]
    return R, T


def apply_rigid(coords: jnp.ndarray, R: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """coords @ R + T with broadcasting over leading batch dims."""
    return coords @ R + T[..., None, :]


def rmsd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-atom RMSD along the last two axes (parity mad/PDB.py:115-117)."""
    d = jnp.sum(jnp.square(a - b), axis=(-1, -2)) / a.shape[-2]
    return jnp.sqrt(d)


def spherical_angles(vecs: jnp.ndarray):
    """(theta in [0, 2pi), phi in [0, pi]) of vectors, reference convention
    (mad/Orientator.py:305-321)."""
    theta = jnp.arctan2(vecs[..., 1], vecs[..., 0])
    theta = jnp.where(theta < 0, theta + 2.0 * jnp.pi, theta)
    phi = jnp.arccos(jnp.clip(vecs[..., 2], -1.0, 1.0))
    return theta, phi


def random_rotation(key) -> jnp.ndarray:
    """Uniform random rotation matrix (for tests / decoy transforms)."""
    q = jax.random.normal(key, (4,))
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
