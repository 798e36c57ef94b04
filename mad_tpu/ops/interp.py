"""Gather-based interpolation of 3D (vector) fields."""

from __future__ import annotations

import jax.numpy as jnp


def trilinear(field: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Trilinear interpolation of field (X, Y, Z, C) at voxel-space points
    (..., 3). Out-of-range points are clamped; callers mask them.

    Matches scipy RegularGridInterpolator(method='linear') inside bounds
    (used by the rigid refiner, mad/structure_utils.py:76-80). The 8 corner
    reads are 1D gathers of flat indices into the collapsed volume.
    """
    x, y, z = field.shape[:3]
    flat = field.reshape(-1, field.shape[3])
    shp = jnp.asarray((x, y, z))
    p = jnp.clip(pts, 0.0, (shp - 1).astype(pts.dtype))
    p0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, shp - 2)
    f = p - p0.astype(p.dtype)
    w0, w1 = 1.0 - f, f
    base = (p0[..., 0] * y + p0[..., 1]) * z + p0[..., 2]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                v = flat[base + (dx * y + dy) * z + dz]
                out = out + w[..., None] * v
    return out


def pack_corners(field: jnp.ndarray, dtype=None) -> jnp.ndarray:
    """Corner-packed layout for single-gather trilinear interpolation.

    Returns ((X-1)*(Y-1)*(Z-1), 32) rows where channels 4c..4c+2 hold the
    3-vector at corner offset c of the cell. One row gather (128 B at f32,
    64 B at bf16) then replaces the 8 corner gathers of ``trilinear`` at
    8x the field memory: on an H100 (700 W), 500 dependent steps of 128
    candidates x 1280 atoms over the bench map's gradient take 14.5 ms
    packed against 39.3 ms with 8 gathers. dtype: optional row storage
    dtype (e.g. bfloat16 halves the row size; values round per element,
    interpolation weights stay f32).
    """
    x, y, z = field.shape[:3]
    if dtype is not None:
        field = field.astype(dtype)
    blocks = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                b = field[dx:x - 1 + dx, dy:y - 1 + dy, dz:z - 1 + dz]
                blocks.append(jnp.concatenate(
                    [b, jnp.zeros(b.shape[:3] + (1,), field.dtype)], -1))
    return jnp.concatenate(blocks, axis=-1).reshape(-1, 32)


def trilinear_packed(packed: jnp.ndarray, dims, pts: jnp.ndarray
                     ) -> jnp.ndarray:
    """Trilinear interpolation from a ``pack_corners`` layout; exactly equal
    to ``trilinear(field, pts)``. dims = original (X, Y, Z)."""
    x, y, z = dims
    shp = jnp.asarray((x, y, z))
    p = jnp.clip(pts, 0.0, (shp - 1).astype(pts.dtype))
    p0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, shp - 2)
    f = p - p0.astype(p.dtype)
    w0, w1 = 1.0 - f, f
    idx = (p0[..., 0] * (y - 1) + p0[..., 1]) * (z - 1) + p0[..., 2]
    rows = packed[idx].astype(pts.dtype)
    out = 0.0
    c = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                out = out + w[..., None] * rows[..., 4 * c: 4 * c + 3]
                c += 1
    return out


def nearest(field: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor gather with .5 ties to the lower index (scipy RGI
    'nearest' parity, used for descriptor sampling)."""
    shp = jnp.asarray(field.shape[:3])
    ids = jnp.clip(jnp.ceil(pts - 0.5).astype(jnp.int32), 0, shp - 1)
    return field[ids[..., 0], ids[..., 1], ids[..., 2]]
