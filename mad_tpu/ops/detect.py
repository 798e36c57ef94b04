"""Anchor detection: local LoG maxima + batched Newton subvoxel localization.

Replaces Detector.find_anchors / check_localize (mad/Detector.py:18-123):
  * peaks = voxels equal to their 3x3x3 neighborhood max, above an absolute
    threshold, away from the (real) border by ``exclude_border`` voxels;
  * top-K peaks by response fill a static-capacity buffer (fixed shapes
    instead of the reference's variable-length Python lists);
  * each peak runs <=5 Newton iterations on a finite-difference Hessian and
    gradient; offsets > 0.6 walk one voxel toward the offset, convergence
    requires all |offset| < 0.6; saddle points (any Hessian eigenvalue > 0,
    tested via characteristic-polynomial invariants) are rejected.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import DetectConfig
from ..utils.warmup import warmable


@dataclass
class Anchors:
    """Static-capacity anchor set for one octave (device arrays)."""

    coords: jnp.ndarray       # (K, 3) int32 voxel coords (post-walk)
    subvox: jnp.ndarray       # (K, 3) float32 subvoxel coords (voxels)
    values: jnp.ndarray       # (K,) float32 LoG response at the seed peak
    valid: jnp.ndarray        # (K,) bool

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]


def _maxpool3(vol: jnp.ndarray) -> jnp.ndarray:
    return lax.reduce_window(
        vol, -jnp.inf, lax.max, (3, 3, 3), (1, 1, 1), "SAME"
    )


def _hessian_grad(patch: jnp.ndarray):
    """Finite-difference Hessian + gradient from a 3x3x3 patch
    (parity: mad/Detector.py:66-79)."""
    c = patch[1, 1, 1]
    xx = patch[0, 1, 1] + patch[2, 1, 1] - 2 * c
    yy = patch[1, 0, 1] + patch[1, 2, 1] - 2 * c
    zz = patch[1, 1, 0] + patch[1, 1, 2] - 2 * c
    xy = 0.25 * ((patch[2, 2, 1] - patch[2, 0, 1]) - (patch[0, 2, 1] - patch[0, 0, 1]))
    xz = 0.25 * ((patch[2, 1, 2] - patch[2, 1, 0]) - (patch[0, 1, 2] - patch[0, 1, 0]))
    yz = 0.25 * ((patch[1, 2, 2] - patch[1, 2, 0]) - (patch[1, 0, 2] - patch[1, 0, 0]))
    H = jnp.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    G = 0.5 * jnp.array(
        [patch[2, 1, 1] - patch[0, 1, 1],
         patch[1, 2, 1] - patch[1, 0, 1],
         patch[1, 1, 2] - patch[1, 1, 0]]
    )
    return H, G


def _inv3(H: jnp.ndarray):
    """Adjugate-based 3x3 inverse; returns (inv, ok)."""
    det = jnp.linalg.det(H)
    ok = jnp.abs(det) > 1e-20
    adj = jnp.array([
        [H[1, 1] * H[2, 2] - H[1, 2] * H[2, 1],
         H[0, 2] * H[2, 1] - H[0, 1] * H[2, 2],
         H[0, 1] * H[1, 2] - H[0, 2] * H[1, 1]],
        [H[1, 2] * H[2, 0] - H[1, 0] * H[2, 2],
         H[0, 0] * H[2, 2] - H[0, 2] * H[2, 0],
         H[0, 2] * H[1, 0] - H[0, 0] * H[1, 2]],
        [H[1, 0] * H[2, 1] - H[1, 1] * H[2, 0],
         H[0, 1] * H[2, 0] - H[0, 0] * H[2, 1],
         H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]],
    ])
    return adj / jnp.where(ok, det, 1.0), ok


def _neg_semidefinite(H: jnp.ndarray) -> jnp.ndarray:
    """All eigenvalues <= 0 for symmetric H, via char-poly invariants.

    Saddle rejection (mad/Detector.py:103-107) keeps anchors only when no
    eigenvalue is positive: trace <= 0, sum of principal 2x2 minors >= 0,
    det <= 0.
    """
    i1 = H[0, 0] + H[1, 1] + H[2, 2]
    i2 = (H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
          + H[0, 0] * H[2, 2] - H[0, 2] * H[2, 0]
          + H[1, 1] * H[2, 2] - H[1, 2] * H[2, 1])
    i3 = jnp.linalg.det(H)
    return (i1 <= 0) & (i2 >= 0) & (i3 <= 0)


def top_peaks(scores: jnp.ndarray, capacity: int):
    """(values, flat indices) of the ``capacity`` largest entries of a flat
    score vector whose non-peaks hold -inf, exactly as ``lax.top_k``
    returns them.

    Above 2^22 entries the top-k runs in two stages: per 4096-entry
    segment a top-512, then a top-k over the candidates. Peaks are at
    least 2 voxels apart, so no segment holds 512 of them and the result is
    exact; segment-major candidate order is flat-index order, so even ties
    come out as the flat top_k orders them. On an H100 one flat top_k over
    the bench's octave 0 (2.35e8 scores, one radix sort) is faster alone
    (8.0 vs 14.3 ms), but the fused describe chain with the two-stage form
    won 5 of 6 end-to-end pairs of the steady bench pass."""
    v = scores.shape[0]
    if v <= (1 << 22):
        return lax.top_k(scores, capacity)
    block = 4096
    seg = jnp.pad(scores, (0, (-v) % block), constant_values=-jnp.inf)
    seg = seg.reshape(-1, block)
    svals, scols = lax.top_k(seg, min(512, block, capacity))
    base = (jnp.arange(seg.shape[0], dtype=jnp.int32) * block)[:, None]
    cand_idx = (base + scols).reshape(-1)
    vals, sub = lax.top_k(svals.reshape(-1), capacity)
    return vals, cand_idx[sub]


def collect_peaks(vol: jnp.ndarray, real_shape: Tuple[int, int, int],
                  threshold: float, exclude_border: int, capacity: int):
    """Seed collection: ``top_peaks`` over the local maxima of ``vol``
    (equal to their 3x3x3 neighbourhood max, above ``threshold``, at least
    ``exclude_border`` voxels inside the real extent)."""
    rx, ry, rz = real_shape
    eb = exclude_border
    pooled = _maxpool3(vol)
    x = jnp.arange(vol.shape[0])[:, None, None]
    y = jnp.arange(vol.shape[1])[None, :, None]
    z = jnp.arange(vol.shape[2])[None, None, :]
    interior = ((x >= eb) & (x < rx - eb) & (y >= eb) & (y < ry - eb)
                & (z >= eb) & (z < rz - eb))
    is_peak = (vol >= pooled) & (vol > threshold) & interior
    return top_peaks(jnp.where(is_peak, vol, -jnp.inf).reshape(-1),
                     capacity)


def _detect_core(shape: Tuple[int, int, int],
                 real_shape: Tuple[int, int, int],
                 threshold: float, exclude_border: int, max_offset: float,
                 n_iter: int, capacity: int, mesh: Mesh = None):
    """Builds the (unjitted) detection closures; shared by the standalone
    program and the fused log+detect program (ops/scalespace.py)."""
    rx, ry, rz = real_shape
    eb = exclude_border

    def localize(vol, seed, gather_off=None, cast=lambda x: x):
        """Newton walk from one peak; returns (coords, subvox, accepted).

        gather_off: optional (3,) offset subtracted from the (global) walk
        position for the 3x3x3 gathers — the sharded path passes a
        halo-extended local block while the walk itself stays in global
        coordinates (bounds clamp against the real extent either way).
        cast: VMA promotion applied to the loop-carry inits — the sharded
        path walks on a shard-varying block, so replicated inits must be
        pvaried for shard_map's varying-manual-axes check."""

        def body(_, state):
            pos, offset, H, accepted, bad = state
            p = pos if gather_off is None else pos - gather_off
            patch = lax.dynamic_slice(vol, (p[0] - 1, p[1] - 1, p[2] - 1),
                                      (3, 3, 3))
            Hn, G = _hessian_grad(patch)
            Hinv, ok = _inv3(Hn)
            off = -(Hinv @ G)
            acc_now = jnp.all(jnp.abs(off) < max_offset) & ok
            # Voxel walk toward the offset, clamped to the interior
            # (parity: mad/Detector.py:92-97, bounds use the real extent).
            lo_ok = pos - 1 > 0
            hi_ok = pos + 1 < jnp.array([rx, ry, rz]) - 1
            step = jnp.where((off < -max_offset) & lo_ok, -1, 0) + \
                   jnp.where((off > max_offset) & hi_ok, 1, 0)
            frozen = accepted | bad
            new_pos = jnp.where(frozen | acc_now, pos, pos + step)
            new_off = jnp.where(frozen, offset, off)
            new_H = jnp.where(frozen, H, Hn)
            return (new_pos, new_off, new_H,
                    accepted | (acc_now & ~bad), bad | (~ok & ~accepted))

        init = (cast(seed), cast(jnp.zeros(3, dtype=vol.dtype)),
                cast(jnp.zeros((3, 3), dtype=vol.dtype)),
                cast(jnp.array(False)), cast(jnp.array(False)))
        pos, offset, H, accepted, _bad = lax.fori_loop(0, n_iter, body, init)
        good = accepted & _neg_semidefinite(H)
        return pos, pos.astype(vol.dtype) + offset, good

    def detect(vol):
        vals, flat_idx = collect_peaks(vol, real_shape, threshold, eb,
                                       capacity)
        seeds = jnp.stack(jnp.unravel_index(flat_idx, shape), axis=-1
                          ).astype(jnp.int32)
        valid_seed = vals > threshold
        # Clamp invalid seeds into the interior so gathers stay in range.
        seeds = jnp.clip(seeds, eb, jnp.array([rx, ry, rz]) - eb - 1)
        pos, subvox, good = jax.vmap(localize, in_axes=(None, 0))(vol, seeds)
        return pos, subvox, vals, valid_seed & good

    if mesh is None:
        return detect

    # Capacity mode (multi-chip): the LoG volume STAYS sharded in x-slabs —
    # no device holds the full field. Each device finds its slab's top-K
    # peaks on a halo-extended block, an all_gather + top_k merges the
    # candidate lists (shard-major order = flat-index order, so tie
    # ordering matches the single-device flat top_k exactly), and each
    # merged seed Newton-localizes on the device owning its slab (halo
    # covers the <= n_iter-voxel walk); a psum rebuilds the replicated
    # anchor table.
    from ..parallel.mesh import mesh_axis, gather_invariant, pvary
    from ..parallel.volume import halo_extend
    ax = mesh_axis(mesh)
    n_sh = mesh.shape[ax]
    blk = shape[0] // n_sh
    halo = 2 + n_iter       # 1 pool + n_iter walk + 1 patch

    def detect_shard(vol_block):
        pidx = lax.axis_index(ax)
        x0 = pidx * blk
        ext = halo_extend(vol_block, halo, ax, n_sh)
        pooled = _maxpool3(ext)[halo:-halo]
        gx = x0 + jnp.arange(blk)[:, None, None]
        y = jnp.arange(shape[1])[None, :, None]
        z = jnp.arange(shape[2])[None, None, :]
        interior = ((gx >= eb) & (gx < rx - eb) & (y >= eb) & (y < ry - eb)
                    & (z >= eb) & (z < rz - eb))
        is_peak = (vol_block >= pooled) & (vol_block > threshold) & interior
        scores = jnp.where(is_peak, vol_block, -jnp.inf).reshape(-1)
        vals_l, flat_l = top_peaks(scores, capacity)
        seeds_l = jnp.stack(
            jnp.unravel_index(flat_l, (blk,) + shape[1:]), axis=-1
        ).astype(jnp.int32) + jnp.array([x0, 0, 0], jnp.int32)[None]
        # Invariant gathers: every device sees the identical merged
        # candidate list, so vals/seeds are replicated by TYPE and the
        # varying-manual-axes check can verify the replicated out_specs.
        vals_all = gather_invariant(vals_l, ax)             # (n, K)
        seeds_all = gather_invariant(seeds_l, ax)           # (n, K, 3)
        vals, sel = lax.top_k(vals_all.reshape(-1), capacity)
        seeds = seeds_all.reshape(-1, 3)[sel]
        valid_seed = vals > threshold
        seeds = jnp.clip(seeds, eb, jnp.array([rx, ry, rz]) - eb - 1)
        own = (seeds[:, 0] >= x0) & (seeds[:, 0] < x0 + blk)
        goff = jnp.array([x0 - halo, 0, 0], jnp.int32)
        pos, subvox, good = jax.vmap(
            lambda s: localize(ext, s, goff, cast=lambda v: pvary(v, ax))
        )(seeds)
        ow = own.astype(jnp.int32)
        pos = lax.psum(pos * ow[:, None], ax)
        subvox = lax.psum(subvox * ow[:, None].astype(subvox.dtype), ax)
        good = lax.psum((good & own).astype(jnp.int32), ax) > 0
        return pos, subvox, vals, valid_seed & good

    sm = shard_map(detect_shard, mesh=mesh,
                   in_specs=(P(ax, None, None),),
                   out_specs=(P(), P(), P(), P()))
    return sm


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_detect(shape: Tuple[int, int, int],
                     real_shape: Tuple[int, int, int],
                     threshold: float, exclude_border: int, max_offset: float,
                     n_iter: int, capacity: int, mesh: Mesh = None):
    return jax.jit(_detect_core(shape, real_shape, threshold, exclude_border,
                                max_offset, n_iter, capacity, mesh))


def detect_anchors(log_vol: jnp.ndarray, real_shape, cfg: DetectConfig,
                   mesh: Mesh = None) -> Anchors:
    """mesh: optional device mesh — capacity mode, the LoG volume arrives
    (and stays) sharded in x-slabs; the anchor table returns replicated."""
    fn = _compiled_detect(tuple(log_vol.shape), tuple(real_shape),
                          float(cfg.threshold_abs), int(cfg.exclude_border),
                          float(cfg.max_offset), int(cfg.newton_iters),
                          int(cfg.max_anchors), mesh)
    pos, subvox, vals, valid = fn(log_vol)
    return Anchors(coords=pos, subvox=subvox, values=vals, valid=valid)
