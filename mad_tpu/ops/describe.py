"""1024-dim rotation-invariant descriptors (batched gather + histograms).

Replaces Descriptor.generate_descriptors / step06
(mad/Descriptor.py:106-202). Per oriented anchor:
  * a patch_size^3 lattice (half-voxel centers on the base octave, stride-2
    odd centers on the upsampled octave, mad/Descriptor.py:32-35) is rotated
    into the anchor frame by R_final^-1 and offset to the anchor;
  * the map's gradient field is sampled at those points with nearest-neighbor
    interpolation (ties round down, matching scipy RegularGridInterpolator);
    any point outside the grid zeroes the whole descriptor
    (mad/Descriptor.py:141-149);
  * samples are normalized, rotated by R_final into the canonical frame and
    binned into subregions x EQSP zones; samples with magnitude < 1e-5 are
    dropped (mad/Descriptor.py:153-198).

Subregion ordering reproduces the reference's slice tables
(mad/Descriptor.py:38-96) so cached descriptors are layout-compatible.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.config import DescribeConfig
from ..core.eqsp import get_eqsp
from ..parallel.mesh import mesh_axis
from .orient import zone_assign_fn
from ..utils.warmup import warmable


def descriptor_lattice(radius: int, upsampled: bool) -> np.ndarray:
    """(P, 3) sample offsets in octave voxels (mad/Descriptor.py:32-35)."""
    if upsampled:
        r = np.arange(-2 * radius + 1, 2 * radius + 1, 2, dtype=np.float32)
    else:
        r = np.arange(-radius + 0.5, radius + 0.5, 1.0, dtype=np.float32)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


def region_ids(radius: int, subregions: int) -> np.ndarray:
    """Static subregion id per lattice point, reference slice-table order
    (mad/Descriptor.py:38-96)."""
    n = 2 * radius
    idx = np.arange(n)
    if subregions == 64:
        bounds = [0, radius // 2, radius, 3 * radius // 2, n]
        b = np.searchsorted(bounds, idx, side="right") - 1
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = by * 16 + bx * 4 + bz
    elif subregions == 27:
        bounds = [0, n // 3, 2 * n // 3, n]
        b = np.searchsorted(bounds, idx, side="right") - 1
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = by * 9 + bx * 3 + bz
    elif subregions == 8:
        b = (idx >= radius).astype(int)
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = bx * 4 + by * 2 + (1 - bz)
    elif subregions == 1:
        reg = np.zeros((n, n, n), dtype=int)
    else:
        raise ValueError(f"invalid subregions {subregions}")
    return reg.reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _describe_body(shape: Tuple[int, int, int],
                   real_shape: Tuple[int, int, int], upsampled: bool,
                   radius: int, subeqsp_size: int, subregions: int,
                   cutoff: float, zero_magn: float, chunk: int):
    """Unjitted descriptor body (shared with _compiled_describe and the
    whole-octave fused chain, engine/pipeline._compiled_octave_chain)."""
    eqsp = get_eqsp(subeqsp_size)
    zone_ids = zone_assign_fn(eqsp)
    lattice_np = descriptor_lattice(radius, upsampled)
    regs = region_ids(radius, subregions)
    # Group lattice points by subregion (static permutation; regions may be
    # unequal for 27 subregions -> pad with -1 sentinels).
    max_pts = int(np.max(np.bincount(regs, minlength=subregions)))
    perm = np.full((subregions, max_pts), -1, dtype=np.int32)
    for r in range(subregions):
        pts = np.nonzero(regs == r)[0]
        perm[r, : len(pts)] = pts
    # Numpy closure constants: device-resident constants cost a host
    # pull per lower (see ops/orient.zone_ids_fn).
    rs = np.asarray(real_shape)
    lattice_f = np.asarray(lattice_np, dtype=np.float32)
    perm_ok = perm >= 0
    perm_clip = np.clip(perm, 0, None)

    def one_descriptor(grad, coord, rfinal, valid_in, goff=None):
        # The in-bounds test is always in GLOBAL coordinates; ``goff``
        # (capacity mode) shifts the sample lattice into a halo-extended
        # local block, clipped to its extent — lanes owned by another shard
        # gather garbage there and carry valid_in=False.
        pts = lattice_f @ rfinal + coord.astype(jnp.float32)
        in_bounds = jnp.all((pts >= 0) & (pts <= (rs - 1).astype(pts.dtype)))
        ok = valid_in & in_bounds
        if goff is not None:
            pts = pts - goff.astype(pts.dtype)
        # Nearest-neighbor with .5 ties to the lower index (scipy RGI parity).
        ids = jnp.clip(jnp.ceil(pts - 0.5).astype(jnp.int32), 0,
                       np.asarray(grad.shape[:3]) - 1)
        g = grad[ids[:, 0], ids[:, 1], ids[:, 2]].astype(jnp.float32)  # (P, 3)
        magn = jnp.linalg.norm(g, axis=-1)
        dirs = jnp.where((magn > cutoff)[:, None],
                         g / jnp.maximum(magn, 1e-30)[:, None], g)
        rotated = dirs @ rfinal.T
        zones = zone_ids(rotated)
        zones = jnp.where(magn < zero_magn, -1, zones)
        zperm = jnp.where(perm_ok, zones[perm_clip], -1)

        def one_zone(z):
            return jnp.sum(zperm == z, axis=-1)                   # (R,)

        counts = lax.map(one_zone, np.arange(subeqsp_size))        # (Z, R)
        desc = jnp.moveaxis(counts, 0, -1).reshape(-1)             # (R*Z,)
        # Counts <= patch_size^3 fit int16 (reference stores int16 too,
        # mad/Descriptor.py:198); halves the device->host pull.
        return jnp.where(ok, desc, 0).astype(jnp.int16), ok

    def describe(grad, coords, rfinals, valid, goff=None):
        d = coords.shape[0]
        n_chunks = d // chunk

        def do_chunk(args):
            c, r, v = args
            return jax.vmap(one_descriptor, in_axes=(None, 0, 0, 0, None))(
                grad, c, r, v, goff)

        descs, ok = lax.map(
            do_chunk,
            (coords.reshape(n_chunks, chunk, 3),
             rfinals.reshape(n_chunks, chunk, 3, 3),
             valid.reshape(n_chunks, chunk)),
        )
        return (descs.reshape(d, subregions * subeqsp_size),
                ok.reshape(d))

    return describe


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_describe(shape: Tuple[int, int, int],
                       real_shape: Tuple[int, int, int], upsampled: bool,
                       radius: int, subeqsp_size: int, subregions: int,
                       cutoff: float, zero_magn: float, chunk: int,
                       mesh: Mesh = None, shard_l: int = 0):
    describe = _describe_body(shape, real_shape, upsampled, radius,
                              subeqsp_size, subregions, cutoff, zero_magn,
                              chunk)
    if mesh is None:
        return jax.jit(describe)
    # Capacity mode (multi-chip): the gradient volume STAYS sharded in
    # x-slabs. Each device describes the (up to shard_l) lanes whose
    # rotated sample lattice it owns, gathering from a halo-extended local
    # block; the per-shard selection order is emitted so descriptor rows
    # map back to input lanes.
    from ..parallel.volume import halo_extend
    ax = mesh_axis(mesh)
    n_sh = mesh.shape[ax]
    blk = shape[0] // n_sh
    stride = 2 if upsampled else 1
    halo = radius * stride * 2      # >= sqrt(3) * lattice reach

    def describe_shard(grad_block, coords, rfinals, valid):
        pidx = lax.axis_index(ax)
        x0 = pidx * blk
        ext = halo_extend(grad_block, halo, ax, n_sh)
        mine = valid & (coords[:, 0] >= x0) & (coords[:, 0] < x0 + blk)
        order = jnp.argsort(~mine, stable=True)[:shard_l].astype(jnp.int32)
        goff = jnp.array([x0 - halo, 0, 0], jnp.int32)
        descs, ok = describe(ext, coords[order], rfinals[order],
                             mine[order], goff)
        return descs, ok, order, jnp.sum(mine)[None]

    sm = shard_map(describe_shard, mesh=mesh,
                   in_specs=(P(ax, None, None, None), P(), P(), P()),
                   out_specs=(P(ax, None), P(ax), P(ax), P(ax)),
                   # replicated lane tables mix with shard-varying
                   # selections inside; skip the static VMA check
                   check_vma=True)
    return jax.jit(sm)


def describe_anchors(grad: jnp.ndarray, coords: jnp.ndarray,
                     rfinals: jnp.ndarray, valid: jnp.ndarray, real_shape,
                     upsampled: bool, cfg: DescribeConfig, chunk: int = 128,
                     mesh: Mesh = None, shard_l: int = 0):
    """Descriptors for compacted oriented-anchor lanes of one octave.

    coords: (D, 3) int32 anchor voxel coords; rfinals: (D, 3, 3).
    Returns (descriptors (D, subregions*subeqsp) int16, valid (D,) bool);
    in capacity mode (mesh) additionally (order, shard_counts): ``grad``
    arrives x-slab-sharded and is never replicated, each device describes
    the lanes whose patch it owns (up to ``shard_l`` per shard, default all
    D — no overflow possible), and row j of the output corresponds to input
    lane order[j].
    """
    radius = (cfg.patch_size - cfg.patch_size % 2) // 2
    d = coords.shape[0]
    if mesh is None:
        assert d % chunk == 0, (d, chunk)
        fn = _compiled_describe(tuple(grad.shape[:3]), tuple(real_shape),
                                bool(upsampled), radius, cfg.subeqsp_size,
                                cfg.subregions, float(cfg.cutoff_magn),
                                float(cfg.zero_magn), chunk)
        return fn(grad, coords, rfinals, valid)
    shard_l = shard_l or d
    assert shard_l % chunk == 0, (shard_l, chunk)
    fn = _compiled_describe(tuple(grad.shape[:3]), tuple(real_shape),
                            bool(upsampled), radius, cfg.subeqsp_size,
                            cfg.subregions, float(cfg.cutoff_magn),
                            float(cfg.zero_magn), chunk, mesh, shard_l)
    rep = NamedSharding(mesh, P())
    coords = jax.device_put(coords, rep)
    rfinals = jax.device_put(rfinals, rep)
    valid = jax.device_put(valid, rep)
    return fn(grad, coords, rfinals, valid)
