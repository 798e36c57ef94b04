"""Canonical orientation assignment (batched EQSP spherical histograms).

Replaces Orientator.assign_orientations + steps 01-05
(mad/Orientator.py:68-343). Reference semantics preserved:
  * gradient patch of (2r+1)^3 samples around each anchor — stride 1 on the
    base octave, stride 2 over a double-size window on the upsampled octave
    (mad/Orientator.py:116-167);
  * spherical corner mask (radius * 1.05) zeroing cube corners, plus samples
    with gradient magnitude < 1e-5 (mad/Orientator.py:37-54, 146-147);
  * 112-zone histogram of gradient directions, quantized to int(count/max*50);
  * candidate dominant bins: quantized count > 0.8 * max, anchor rejected if
    more than 6 (mad/Orientator.py:181-186);
  * per dominant bin: rotate its EQSP center to +z, re-histogram, candidate
    secondary bins from zones 1..N-2 (pole and south cap excluded),
    renormalized and thresholded the same way, <= 6 (mad/Orientator.py:215-242);
  * per (main, sec): R_final = Rz(-(theta_c(sec) - theta_first(belt))) @ R_main
    (mad/Orientator.py:105, 244-270).

The reference deep-copies anchors per candidate in a Python loop; here every
(anchor, main, sec) triple is a masked lane of fixed-width axes (K, 6, 6),
processed in anchor chunks under vmap.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.config import OrientConfig
from ..parallel.mesh import mesh_axis
from ..core.eqsp import EQSPSphere, get_eqsp
from ..core.geometry import rotation_about_z, spherical_angles
from .detect import Anchors
from ..utils.warmup import warmable

TWO_PI = 2.0 * np.pi


@dataclass
class OrientedAnchors:
    """Fixed-width (K, M, S) oriented-anchor lanes for one octave.

    In capacity mode (mesh) K = n_shards * shard_k and ``anchor_idx`` maps
    each lane row back to its global anchor slot (per-shard selection
    order); ``shard_counts`` carries each shard's owned-anchor count so
    callers can detect shard_k overflow."""

    anchor_idx: jnp.ndarray   # (K,) index into the Anchors buffer
    main_bin: jnp.ndarray     # (K, M) int32
    sec_bin: jnp.ndarray      # (K, M, S) int32
    rfinal: jnp.ndarray       # (K, M, S, 3, 3) float32
    valid: jnp.ndarray        # (K, M, S) bool
    shard_counts: jnp.ndarray = None   # (n_shards,) int32, mesh only


def zone_ids_fn(eqsp: EQSPSphere):
    """Jittable direction -> EQSP zone assignment closure.

    Closure constants stay NUMPY: eager ``jnp.asarray`` would park them on
    the device, and embedding a device-resident constant into MLIR at
    lower time forces a device-to-host pull per constant. Numpy constants
    embed host-side with zero pulls."""
    colat_edges, belt_start, belt_count, belt_theta0 = eqsp.zone_lookup_tables()
    edges = np.asarray(colat_edges[:-1])
    starts = np.asarray(belt_start)
    counts = np.asarray(belt_count)
    theta0s = np.asarray(belt_theta0)

    def zone_ids(dirs):
        theta, phi = spherical_angles(dirs)
        belt = jnp.clip(
            jnp.searchsorted(edges, phi, side="right"), 0, starts.shape[0] - 1
        )
        cnt = jnp.take(counts, belt)
        m = cnt.astype(dirs.dtype)
        rel = (theta - jnp.take(theta0s, belt)) / (TWO_PI / m)
        k = jnp.floor(rel - jnp.floor(rel / m) * m)
        k = jnp.clip(k.astype(jnp.int32), 0, cnt - 1)
        return jnp.take(starts, belt) + k

    return zone_ids


def weighted_histogram(ids: jnp.ndarray, weights: jnp.ndarray, nzones: int
                       ) -> jnp.ndarray:
    """counts[..., z] = sum over last axis of weights where ids == z."""

    def one_zone(z):
        return jnp.sum(jnp.where(ids == z, weights, 0.0), axis=-1)

    counts = lax.map(one_zone, np.arange(nzones, dtype=np.int32))
    return jnp.moveaxis(counts, 0, -1)


def ref_zone_bounds(eqsp: EQSPSphere) -> np.ndarray:
    """Zone bounds [theta_min, phi_min, theta_max, phi_max] rounded to four
    decimals — the precision of the reference's shipped tables
    (mad/eqsp/sphere_{16,112}.txt), which its strict-inequality masks
    compare against. Boundary-exact directions therefore bin exactly as the
    reference bins them (e.g. theta == 0 joins a belt's LAST zone through
    the +2pi shift; directions exactly on an interior boundary match no
    zone)."""
    return np.round(eqsp.bounds, 4).astype(np.float32)


def zone_hist_fn(eqsp: EQSPSphere):
    """Jittable weighted zone histogram with the reference's mask semantics
    (mad/Orientator.py:323-335): per zone, strict bounds on theta (or
    theta + 2pi, for zones whose table range exceeds 2pi) and phi."""
    b = ref_zone_bounds(eqsp)          # numpy: see zone_ids_fn

    def hist(dirs, w):
        theta, phi = spherical_angles(dirs)
        sth = theta + TWO_PI

        def one_zone(area):
            th_ok = (theta > area[0]) & (theta < area[2])
            sth_ok = (sth > area[0]) & (sth < area[2])
            ph_ok = (phi > area[1]) & (phi < area[3])
            return jnp.sum(
                jnp.where((th_ok | sth_ok) & ph_ok, w, 0.0), axis=-1)

        counts = lax.map(one_zone, b)
        return jnp.moveaxis(counts, 0, -1)

    return hist


def zone_assign_fn(eqsp: EQSPSphere):
    """Jittable per-direction zone assignment with the reference
    *descriptor* semantics (mad/Descriptor.py:173-190): strict 4-decimal
    boundary masks, the LAST matching zone wins (the reference overwrites a
    zone array in zone order), and unmatched directions default to zone 0
    (the array is zero-initialized)."""
    b = ref_zone_bounds(eqsp)          # numpy: see zone_ids_fn
    zidx = np.arange(b.shape[0], dtype=np.int32)

    def assign(dirs):
        theta, phi = spherical_angles(dirs)
        sth = theta + TWO_PI
        th_ok = (theta[..., None] > b[:, 0]) & (theta[..., None] < b[:, 2])
        sth_ok = (sth[..., None] > b[:, 0]) & (sth[..., None] < b[:, 2])
        ph_ok = (phi[..., None] > b[:, 1]) & (phi[..., None] < b[:, 3])
        mask = (th_ok | sth_ok) & ph_ok
        zid = jnp.max(jnp.where(mask, zidx, -1), axis=-1)
        return jnp.maximum(zid, 0).astype(jnp.int32)

    return assign


def _quantize(counts: jnp.ndarray) -> jnp.ndarray:
    """int32(count / max * 50), max-safe (mad/Orientator.py:340)."""
    m = jnp.max(counts, axis=-1, keepdims=True)
    return (counts / jnp.maximum(m, 1e-30) * 50.0).astype(jnp.int32)


def _first_k_flagged(flag: jnp.ndarray, k: int):
    """Indices of the first k true lanes (ascending), plus the total count."""
    order = jnp.argsort(~flag, stable=True)
    n = jnp.sum(flag)
    return order[:k], n


def _ref_rotation_to_pole(theta: float, phi: float) -> np.ndarray:
    """Float64 host rotation taking the (theta, phi) zone center to +z,
    computed exactly as the reference does (angle = arccos(c.z), axis =
    normalize(c x z), Euler-Rodrigues; mad/Orientator.py:197-203,
    mad/math_utils.py:15-27)."""
    c = np.array([np.sin(phi) * np.cos(theta),
                  np.sin(phi) * np.sin(theta), np.cos(phi)])
    angle = np.arccos(np.clip(c[2], -1.0, 1.0))
    ax = np.cross(c, [0.0, 0.0, 1.0])
    n = np.linalg.norm(ax)
    ax = ax / n if n > 0 else np.array([0.0, 1.0, 0.0])
    a = np.cos(angle / 2.0)
    b, cc, d = -ax * np.sin(angle / 2.0)
    return np.array([
        [a * a + b * b - cc * cc - d * d, 2 * (b * cc + a * d),
         2 * (b * d - a * cc)],
        [2 * (b * cc - a * d), a * a + cc * cc - b * b - d * d,
         2 * (cc * d + a * b)],
        [2 * (b * d + a * cc), 2 * (cc * d - a * b),
         a * a + d * d - b * b - cc * cc],
    ])


def _sphere_mask(radius: int, gw_sig: float) -> np.ndarray:
    """Corner-removal mask (+ optional Gaussian window),
    parity mad/Orientator.py:37-54."""
    r = np.arange(-radius, radius + 1)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    sumsq = gx * gx + gy * gy + gz * gz
    mask = (np.sqrt(sumsq) <= radius * 1.05).astype(np.float32)
    if gw_sig:
        mask = mask * np.exp(-sumsq / (2.0 * gw_sig ** 2)).astype(np.float32)
    return mask


@functools.lru_cache(maxsize=32)
def _orient_bodies(shape: Tuple[int, int, int],
                   real_shape: Tuple[int, int, int], stride: int,
                   radius: int, eqsp_size: int, max_main: int, max_sec: int,
                   cutoff: float, gw_sig: float, chunk: int,
                   lane_cap: int = 0):
    """Unjitted orientation bodies: (orient, orient_fused-or-None). Shared
    between _compiled_orient and the whole-octave fused chain
    (engine/pipeline._compiled_octave_chain)."""
    eqsp = get_eqsp(eqsp_size)
    hist = zone_hist_fn(eqsp)
    mask_np = _sphere_mask(radius, gw_sig).reshape(-1)
    offs = np.arange(-radius, radius + 1) * stride
    ox, oy, oz = np.meshgrid(offs, offs, offs, indexing="ij")
    offsets_np = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3)  # (P, 3)
    # Main-bin rotations precompute on host in float64 with the reference's
    # exact recipe (mad/Orientator.py:197-203 + mad/math_utils.py:15-27) on
    # the 4-decimal polar centers its tables ship: e.g. the south cap
    # center is (-7.3e-6, 0, -1), so its rotate-to-pole is the +y half turn
    # through angle 3.1416 (not pi) — reproducing even the tiny off-pole
    # terms that decide nearest-neighbor tie-breaks in the descriptor
    # gather downstream.
    p4 = np.round(eqsp.p_centers, 4)
    th4, ph4 = p4[:, 0], p4[:, 1]
    rot_to_pole = np.stack([_ref_rotation_to_pole(t, f)
                            for t, f in zip(th4, ph4)])
    # Numpy closure constants: see zone_ids_fn (device-resident constants
    # cost a host pull per lower).
    rot_to_pole_t = np.asarray(rot_to_pole, dtype=np.float32)
    p_theta = np.asarray(th4, dtype=np.float32)
    belt_first = np.asarray(np.round(eqsp.belt_first_theta, 4),
                            dtype=np.float32)
    rs = np.asarray(real_shape)
    offsets_i32 = offsets_np.astype(np.int32)
    mask_f = np.asarray(mask_np, dtype=np.float32)
    half = radius * stride

    def one_anchor(grad, coord, valid_in, goff=None):
        # Border rejection (parity mad/Orientator.py:127-155: upper bound is
        # conservative by one voxel, xp > s-1 rejects). The bounds test is
        # always in GLOBAL coordinates; ``goff`` (capacity mode) shifts the
        # gather into a halo-extended local block, clamped to its extent —
        # lanes whose anchor lives on another shard gather garbage there and
        # carry valid_in=False.
        ok = valid_in & jnp.all(coord - half >= 0) & \
            jnp.all(coord + half + 1 <= rs - 1)
        if goff is None:
            safe = jnp.clip(coord, half, jnp.maximum(rs - half - 1, half))
        else:
            gdim = np.asarray(grad.shape[:3], np.int32)
            safe = jnp.clip(coord - goff, half,
                            np.maximum(gdim - half - 1, half))
        pts = safe[None, :] + offsets_i32                               # (P,3)
        g = grad[pts[:, 0], pts[:, 1], pts[:, 2]].astype(jnp.float32)   # (P,3)
        magn = jnp.linalg.norm(g, axis=-1)
        dirs = g / jnp.maximum(magn, 1e-30)[:, None]
        w = mask_f * (magn >= cutoff)

        q0 = _quantize(hist(dirs, w))
        flag0 = q0 > jnp.max(q0) * 0.8
        main_idx, n_main = _first_k_flagged(flag0, max_main)
        ok = ok & (n_main >= 1) & (n_main <= max_main) & (jnp.max(q0) > 0)

        def per_main(mbin):
            Rm = jnp.take(rot_to_pole_t, mbin, axis=0)
            Rm = jnp.where(mbin == 0, jnp.eye(3, dtype=Rm.dtype), Rm)
            q1 = _quantize(hist(dirs @ Rm.T, w))
            not_pole = q1[1:-1]
            m1 = jnp.max(not_pole)
            nq = (not_pole.astype(jnp.float32)
                  / jnp.maximum(m1, 1).astype(jnp.float32) * 50.0
                  ).astype(jnp.int32)
            flag1 = (nq > jnp.max(nq) * 0.8) & (m1 > 0)
            sec_idx, n_sec = _first_k_flagged(flag1, max_sec)
            sec_bins = sec_idx.astype(jnp.int32) + 1
            main_ok = (m1 > 0) & (n_sec >= 1) & (n_sec <= max_sec)
            ftheta = -(jnp.take(p_theta, sec_bins)
                       - jnp.take(belt_first, sec_bins))
            Rz = rotation_about_z(ftheta)                      # (S, 3, 3)
            rfin = Rz @ Rm[None]
            sec_ok = np.arange(max_sec) < n_sec
            return sec_bins, rfin, main_ok & sec_ok

        mains = main_idx.astype(jnp.int32)
        sec_bins, rfin, sub_ok = jax.vmap(per_main)(mains)
        main_ok = np.arange(max_main) < n_main
        valid = ok & main_ok[:, None] & sub_ok
        return mains, sec_bins, rfin, valid

    def orient(grad, coords, valid, goff=None):
        k = coords.shape[0]
        n_chunks = k // chunk

        def do_chunk(args):
            c, v = args
            return jax.vmap(one_anchor, in_axes=(None, 0, 0, None))(
                grad, c, v, goff)

        outs = lax.map(
            do_chunk,
            (coords.reshape(n_chunks, chunk, 3), valid.reshape(n_chunks, chunk)),
        )
        mains, secs, rfin, ok = outs
        return (mains.reshape(k, max_main),
                secs.reshape(k, max_main, max_sec),
                rfin.reshape(k, max_main, max_sec, 3, 3),
                ok.reshape(k, max_main, max_sec))

    orient_fused = None
    if lane_cap:
        # Fused orientation + lane compaction (single-device fast path):
        # valid lanes first into a STATIC lane_cap frame, ready for the
        # descriptor program — no intermediate host sync, no
        # data-dependent capacity bucket.
        ms = max_main * max_sec

        def orient_fused(grad, coords, valid):
            mains, secs, rfin, ok = orient(grad, coords, valid)
            flat_ok = ok.reshape(-1)
            order = jnp.argsort(~flat_ok, stable=True)[:lane_cap]
            lane_anchor = (order // ms).astype(jnp.int32)
            lane_main = ((order // max_sec) % max_main).astype(jnp.int32)
            lane_sec = (order % max_sec).astype(jnp.int32)
            return (mains, secs, rfin.reshape(-1, 3, 3)[order],
                    flat_ok[order], lane_anchor, lane_main, lane_sec,
                    coords[lane_anchor], jnp.sum(flat_ok))

    return orient, orient_fused


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_orient(shape: Tuple[int, int, int],
                     real_shape: Tuple[int, int, int], stride: int,
                     radius: int, eqsp_size: int, max_main: int, max_sec: int,
                     cutoff: float, gw_sig: float, chunk: int,
                     mesh: Mesh = None, shard_k: int = 0, lane_cap: int = 0):
    orient, orient_fused = _orient_bodies(
        shape, real_shape, stride, radius, eqsp_size, max_main, max_sec,
        cutoff, gw_sig, chunk, lane_cap)
    if lane_cap:
        return jax.jit(orient_fused)

    if mesh is None:
        return jax.jit(orient)
    # Capacity mode (multi-chip): the gradient volume STAYS sharded in
    # x-slabs — no device materializes the full field. Each device runs the
    # SAME orient body on the (up to shard_k) anchors whose patch it owns,
    # gathering from a halo-extended local block; the per-shard selection
    # order is emitted so lanes map back to global anchor slots, plus the
    # per-shard owned-anchor count (overflow detection).
    from ..parallel.volume import halo_extend
    ax = mesh_axis(mesh)
    n_sh = mesh.shape[ax]
    blk = shape[0] // n_sh
    halo = radius * stride * 2      # covers orient reach (r*stride) and the
                                    # rotated describe lattice (sqrt(3)*~2r)

    def orient_shard(grad_block, coords, valid):
        pidx = lax.axis_index(ax)
        x0 = pidx * blk
        ext = halo_extend(grad_block, halo, ax, n_sh)
        mine = valid & (coords[:, 0] >= x0) & (coords[:, 0] < x0 + blk)
        order = jnp.argsort(~mine, stable=True)[:shard_k].astype(jnp.int32)
        goff = jnp.array([x0 - halo, 0, 0], jnp.int32)
        mains, secs, rfin, ok = orient(ext, coords[order], mine[order], goff)
        return mains, secs, rfin, ok, order, jnp.sum(mine)[None]

    sm = shard_map(orient_shard, mesh=mesh,
                   in_specs=(P(ax, None, None, None), P(), P()),
                   out_specs=(P(ax, None), P(ax, None, None),
                              P(ax, None, None, None, None),
                              P(ax, None, None), P(ax), P(ax)),
                   # replicated anchor tables mix with shard-varying
                   # selections inside; skip the static VMA check
                   check_vma=True)
    return jax.jit(sm)


def orient_anchors(grad: jnp.ndarray, anchors: Anchors, real_shape,
                   upsampled: bool, cfg: OrientConfig, chunk: int = 128,
                   mesh: Mesh = None, shard_k: int = 0) -> OrientedAnchors:
    """Assign canonical frames to all anchors of one octave.

    mesh (capacity mode): ``grad`` arrives x-slab-sharded and is never
    replicated; each device orients the anchors whose patches it owns
    (up to ``shard_k`` per shard, default the full capacity — no overflow
    possible). The anchor table is replicated (it is tiny)."""
    radius = (cfg.patch_size - cfg.patch_size % 2) // 2
    stride = 2 if upsampled else 1
    k = anchors.capacity
    if mesh is None:
        assert k % chunk == 0, (k, chunk)
        fn = _compiled_orient(tuple(grad.shape[:3]), tuple(real_shape),
                              stride, radius, cfg.eqsp_size, cfg.max_main,
                              cfg.max_sec, float(cfg.cutoff_magn),
                              float(cfg.gw_sig), chunk)
        mains, secs, rfin, ok = fn(grad, anchors.coords, anchors.valid)
        return OrientedAnchors(
            anchor_idx=jnp.arange(k, dtype=jnp.int32),
            main_bin=mains, sec_bin=secs, rfinal=rfin, valid=ok,
        )
    shard_k = shard_k or k
    assert shard_k % chunk == 0, (shard_k, chunk)
    fn = _compiled_orient(tuple(grad.shape[:3]), tuple(real_shape), stride,
                          radius, cfg.eqsp_size, cfg.max_main, cfg.max_sec,
                          float(cfg.cutoff_magn), float(cfg.gw_sig), chunk,
                          mesh, shard_k)
    coords_d = jax.device_put(anchors.coords, NamedSharding(mesh, P()))
    valid_d = jax.device_put(anchors.valid, NamedSharding(mesh, P()))
    mains, secs, rfin, ok, order, counts = fn(grad, coords_d, valid_d)
    return OrientedAnchors(
        anchor_idx=order, main_bin=mains, sec_bin=secs, rfinal=rfin,
        valid=ok, shard_counts=counts)
