"""Rigid-body gradient-ascent refinement, vmapped over pose candidates.

Replaces structure_utils.refine_pdb (mad/structure_utils.py:58-161): 500
alternating translation/rotation steps driven by the map's density gradient,
with per-batch step-size halving and convergence when the step drops below
``min_step``. The reference refines one candidate at a time in a Python
loop with per-step scipy interpolation; here all candidates advance together
under one ``lax.scan`` with batched trilinear gathers.

Semantics preserved per step:
  * coords are rebuilt from the candidate's start pose as
    (Y0 - center) @ rot + center + trans (center = initial centroid);
  * translation steps move along the normalized sum of atom gradients
    by step_size; rotation steps rotate about the normalized total torque
    sum(cross(grad, coords - center)) by step_size / max_dist_from_center
    (torque arm centered on the initial centroid, a reference quirk,
    mad/structure_utils.py:121-122);
  * atoms outside the (strict) map interior contribute nothing;
  * every 4 steps, if the max atom displacement since the last checkpoint is
    below step_size, step_size halves; convergence at step_size < min_step.
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

from ..core.config import RefineConfig, bucket
from ..core.geometry import axis_angle_mat, unit
from ..core.grid import DensityGrid
from ..parallel.mesh import batch_bucket, mesh_axis
from ..ops.interp import pack_corners, trilinear, trilinear_packed
from ..utils.warmup import warmable


@dataclass
class RefineResult:
    rot: np.ndarray           # (C, 3, 3) total rotation (about the centroid)
    trans: np.ndarray         # (C, 3) total translation
    coords: np.ndarray        # (C, N, 3) refined atom coordinates
    converged: np.ndarray     # (C,) bool
    steps: np.ndarray         # (C,) int32 active steps until convergence
    failed: np.ndarray = None # (C,) bool: numerical failure (NaN guard,
                              # parity: mad/structure_utils.py:97-98 returns
                              # NaN and aborts that candidate)
    extra: tuple = None       # caller arrays pulled in the consolidated
                              # device_get (fused dock bookkeeping)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_refine(shape: Tuple[int, int, int], c: int, n: int,
                     n_steps: int, max_step: float, min_step: float,
                     batch_size: int, field_dtype: str = "float32",
                     mesh: "Mesh" = None):
    def refine(map_data, y0, atom_valid, origin, voxsp, trans0, rot0,
               step_size0, prev0, frozen0, failed0, counts0, step0, stop_at):
        """y0: (C, N, 3) start coords; atom_valid: (N,) padding mask.

        The refinement state (trans/rot/step-size/checkpoint/flags and the
        global step counter) is an explicit argument so the driver can run
        the loop in SEGMENTS: after an early segment most candidates have
        converged and the survivors compact into a smaller batch — same
        trajectories (every step is lane-independent), ~half the lane-steps.

        C is whatever candidate slab arrives: the full axis single-device,
        one shard of it under shard_map (each device refines its candidates
        independently; the collective while_loop exit is per-device)."""
        c = y0.shape[0]
        # Map gradient computed on device (parity: np.gradient of the raw
        # processed map, mad/structure_utils.py:80).
        gx, gy, gz = jnp.gradient(map_data)
        grad_field = jnp.stack([gx, gy, gz], axis=-1)
        # Corner-packed field: one 128B-row gather per atom per step instead
        # of 8 corner gathers (exactly equal values, ~2x faster; costs 8x
        # field memory so it is gated on volume size).
        row_bytes = 128 if field_dtype == "float32" else 64
        use_packed = (shape[0] * shape[1] * shape[2]) * row_bytes < 4 << 30
        if use_packed:
            packed = pack_corners(
                grad_field, None if field_dtype == "float32" else field_dtype)
        av = atom_valid.astype(y0.dtype)
        n_atoms = jnp.maximum(jnp.sum(av), 1.0)
        center = (jnp.sum(y0 * av[None, :, None], axis=1, keepdims=True)
                  / n_atoms)                                    # (C, 1, 3)
        max_dist = jnp.max(
            jnp.linalg.norm(y0 - center, axis=-1) * av[None, :], axis=1)
        hi_bound = origin + (jnp.asarray(shape) - 1) * voxsp

        def body(state, step):
            trans, rot, step_size, prev, frozen, failed = state
            coords = (y0 - center) @ rot + center + trans[:, None]
            inb = jnp.all((coords > origin) & (coords < hi_bound), axis=-1)
            w = (inb & atom_valid[None]).astype(coords.dtype)
            vox = (coords - origin) / voxsp
            if use_packed:
                g = trilinear_packed(packed, shape, vox) * w[..., None]
            else:
                g = trilinear(grad_field, vox) * w[..., None]   # (C, N, 3)

            is_trans = (step % 2) == 0
            # Translation move (mad/structure_utils.py:109-116).
            dtrans = unit(jnp.sum(g, axis=1)) * step_size[:, None]
            # Rotation move (mad/structure_utils.py:119-138).
            torque = unit(jnp.sum(jnp.cross(g, coords - center), axis=1))
            angle = step_size / jnp.maximum(max_dist, 1e-6)
            rstep = axis_angle_mat(torque, angle)

            upd = ~frozen
            new_trans = jnp.where((upd & is_trans)[:, None],
                                  trans + dtrans, trans)
            new_rot = jnp.where((upd & ~is_trans)[:, None, None],
                                rot @ rstep, rot)
            new_coords = (y0 - center) @ new_rot + center + new_trans[:, None]

            at_batch = (step + 1) % batch_size == 0
            disp = jnp.max(
                jnp.linalg.norm(prev - new_coords, axis=-1) * av[None],
                axis=1)
            shrink = at_batch & (disp < step_size) & upd
            new_step = jnp.where(shrink, step_size * 0.5, step_size)
            take_prev = at_batch & upd
            new_prev = jnp.where(take_prev[:, None, None], new_coords, prev)
            # NaN guard: a diverging candidate freezes and is flagged
            # (the reference aborts it, mad/structure_utils.py:97-98).
            finite = jnp.all(jnp.isfinite(new_coords), axis=(1, 2)) & \
                jnp.all(jnp.isfinite(new_trans), axis=1)
            new_failed = failed | ~finite
            new_frozen = frozen | (new_step < min_step) | new_failed
            return (new_trans, new_rot, new_step, new_prev, new_frozen,
                    new_failed), jnp.where(frozen, 0, 1)

        # while_loop instead of a fixed scan: once every candidate's step
        # size has decayed below min_step the loop exits (the reference
        # breaks per candidate at mad/structure_utils.py:150-152; batching
        # makes the exit collective).
        def cond(carry):
            step, state, _ = carry
            frozen = state[4]
            return (step < stop_at) & jnp.any(~frozen)

        def loop(carry):
            step, state, counts = carry
            new_state, took = body(state, step)
            return step + 1, new_state, counts + took

        init_state = (trans0, rot0, step_size0, prev0, frozen0, failed0)
        _, (trans, rot, step_size, prev, frozen, failed), counts = \
            lax.while_loop(cond, loop, (step0, init_state, counts0))
        coords = (y0 - center) @ rot + center + trans[:, None]
        return (rot, trans, coords, frozen, counts, failed, step_size, prev)

    if mesh is None:
        return jax.jit(refine)
    # Multi-chip: the SAME body runs per device on its candidate shard (DP
    # over independent pose-refinement scans; map replicated).
    ax = mesh_axis(mesh)
    sm = shard_map(refine, mesh=mesh,
                   in_specs=(P(), P(ax, None, None), P(), P(), P(),
                             P(ax, None), P(ax, None, None), P(ax),
                             P(ax, None, None), P(ax), P(ax), P(ax),
                             P(), P()),
                   out_specs=(P(ax, None, None), P(ax, None),
                              P(ax, None, None), P(ax), P(ax), P(ax),
                              P(ax), P(ax, None, None)),
                   # the while_loop carry mixes replicated inits with
                   # shard-varying updates; skip the static VMA check
                   check_vma=True)
    return jax.jit(sm)


def _pow2_bucket(k: int, lo: int = 4) -> int:
    b = lo
    while b < k:
        b *= 2
    return b


def _cascade_frames(c: int, lo: int = 8) -> Tuple[int, ...]:
    """Static lane-frame sizes for the cascade: halve until ``lo``."""
    frames = [c]
    while frames[-1] > lo:
        frames.append(max(lo, (frames[-1] + 1) // 2))
    return tuple(frames)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_refine_cascade(shape: Tuple[int, int, int], c: int, n: int,
                             n_steps: int, max_step: float, min_step: float,
                             batch_size: int, field_dtype: str = "float32"):
    """Whole refinement as ONE device program with on-device compaction.

    A chain of ``lax.while_loop`` phases over statically halved lane
    frames: each phase steps the full physics until the number of active
    (unfrozen) lanes fits the next frame, then a stable argsort permutes
    active lanes to the front and the state slices down. The segmented
    path's survivor compaction thus happens WITHOUT the host sync it pays
    for the frozen-mask pull — and at an adaptive step instead of a fixed
    one. Every step is lane-independent (reductions run within a lane), so
    trajectories are bitwise identical to the monolithic loop (tested)."""
    frames = _cascade_frames(c)

    def refine(map_data, y0, atom_valid, origin, voxsp, frozen_init):
        gx, gy, gz = jnp.gradient(map_data)
        grad_field = jnp.stack([gx, gy, gz], axis=-1)
        row_bytes = 128 if field_dtype == "float32" else 64
        use_packed = (shape[0] * shape[1] * shape[2]) * row_bytes < 4 << 30
        if use_packed:
            packed = pack_corners(
                grad_field, None if field_dtype == "float32" else field_dtype)
        av = atom_valid.astype(y0.dtype)
        n_atoms = jnp.maximum(jnp.sum(av), 1.0)
        center = (jnp.sum(y0 * av[None, :, None], axis=1, keepdims=True)
                  / n_atoms)                                    # (c, 1, 3)
        max_dist = jnp.max(
            jnp.linalg.norm(y0 - center, axis=-1) * av[None, :], axis=1)
        hi_bound = origin + (jnp.asarray(shape) - 1) * voxsp

        def body(y0_p, center_p, max_dist_p, state, step):
            trans, rot, step_size, prev, frozen, failed = state
            coords = (y0_p - center_p) @ rot + center_p + trans[:, None]
            inb = jnp.all((coords > origin) & (coords < hi_bound), axis=-1)
            w = (inb & atom_valid[None]).astype(coords.dtype)
            vox = (coords - origin) / voxsp
            if use_packed:
                g = trilinear_packed(packed, shape, vox) * w[..., None]
            else:
                g = trilinear(grad_field, vox) * w[..., None]

            is_trans = (step % 2) == 0
            dtrans = unit(jnp.sum(g, axis=1)) * step_size[:, None]
            torque = unit(jnp.sum(jnp.cross(g, coords - center_p), axis=1))
            angle = step_size / jnp.maximum(max_dist_p, 1e-6)
            rstep = axis_angle_mat(torque, angle)

            upd = ~frozen
            new_trans = jnp.where((upd & is_trans)[:, None],
                                  trans + dtrans, trans)
            new_rot = jnp.where((upd & ~is_trans)[:, None, None],
                                rot @ rstep, rot)
            new_coords = ((y0_p - center_p) @ new_rot + center_p
                          + new_trans[:, None])

            at_batch = (step + 1) % batch_size == 0
            disp = jnp.max(
                jnp.linalg.norm(prev - new_coords, axis=-1) * av[None],
                axis=1)
            shrink = at_batch & (disp < step_size) & upd
            new_step = jnp.where(shrink, step_size * 0.5, step_size)
            take_prev = at_batch & upd
            new_prev = jnp.where(take_prev[:, None, None], new_coords, prev)
            finite = jnp.all(jnp.isfinite(new_coords), axis=(1, 2)) & \
                jnp.all(jnp.isfinite(new_trans), axis=1)
            new_failed = failed | ~finite
            new_frozen = frozen | (new_step < min_step) | new_failed
            return (new_trans, new_rot, new_step, new_prev, new_frozen,
                    new_failed), jnp.where(frozen, 0, 1)

        def run_phase(consts, carry, exit_active: int):
            """While active lanes exceed ``exit_active``, keep stepping."""
            y0_p, center_p, max_dist_p = consts

            def cond(cr):
                step, state, _ = cr
                frozen = state[4]
                return ((step < n_steps)
                        & (jnp.sum(~frozen) > exit_active))

            def loop(cr):
                step, state, counts = cr
                new_state, took = body(y0_p, center_p, max_dist_p, state,
                                       step)
                return step + 1, new_state, counts + took

            return lax.while_loop(cond, loop, carry)

        trans = jnp.zeros((c, 3), jnp.float32)
        rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (c, 3, 3))
        step_size = jnp.full((c,), max_step, jnp.float32)
        counts = jnp.zeros((c,), jnp.int32)
        state = (trans, rot, step_size, y0, frozen_init,
                 jnp.zeros((c,), bool))
        consts = (y0, center, max_dist)
        step = jnp.int32(0)

        # Full-frame arrays in ORIGINAL lane order; each boundary permutes
        # actives first, slices to the next frame, and scatters back after.
        full_state, full_counts = state, counts
        full_consts = consts
        perm_chain = None  # original-order full arrays are rebuilt per phase
        for i, f in enumerate(frames):
            exit_active = frames[i + 1] if i + 1 < len(frames) else 0
            if i == 0:
                sl_state, sl_counts, sl_consts = (full_state, full_counts,
                                                  full_consts)
                perm = None
            else:
                frozen_full = full_state[4]
                perm = jnp.argsort(frozen_full, stable=True)
                take = perm[:f]
                sl_state = tuple(a[take] for a in full_state)
                sl_counts = full_counts[take]
                sl_consts = tuple(a[take] for a in full_consts)
            step, sl_state, sl_counts = run_phase(
                sl_consts, (step, sl_state, sl_counts), exit_active)
            if perm is None:
                full_state, full_counts = sl_state, sl_counts
            else:
                take = perm[:f]
                full_state = tuple(
                    a.at[take].set(b) for a, b in zip(full_state, sl_state))
                full_counts = full_counts.at[take].set(sl_counts)

        (trans, rot, step_size, prev, frozen, failed) = full_state
        coords = (y0 - center) @ rot + center + trans[:, None]
        return rot, trans, coords, frozen, full_counts, failed

    return jax.jit(refine)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_refine_merge(c: int, c2: int, n: int):
    """Scatter the compacted second segment's results back into the full
    candidate frame ON DEVICE (``ix`` rows beyond the real survivor count
    are out-of-range and drop). Lets callers chain further device programs
    onto the merged refinement state without a host round trip."""

    def merge(ix, rot1, trans1, coords1, steps1, failed1,
              rot2, trans2, coords2, steps2, failed2):
        return (rot1.at[ix].set(rot2, mode="drop"),
                trans1.at[ix].set(trans2, mode="drop"),
                coords1.at[ix].set(coords2, mode="drop"),
                steps1.at[ix].set(steps2, mode="drop"),
                failed1.at[ix].set(failed2, mode="drop"))

    return jax.jit(merge)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_refine_compact(c: int, c2: int, n: int):
    """Gather the surviving candidates' segment state into a smaller batch
    in ONE device program (keyed by the (c, c2) bucket pair, so the warm
    manifest replays it). Replaces host-side compaction, which pulled the
    full (c, n, 3) coordinate/checkpoint state (~3 MB) and re-uploaded the
    compacted slices every pass."""

    def compact(ix, y0, trans, rot, ssize, prev, frozen, failed, steps):
        return (y0[ix], trans[ix], rot[ix], ssize[ix], prev[ix],
                frozen[ix], failed[ix], steps[ix])

    return jax.jit(compact)


def refine_candidates(dmap: DensityGrid, start_coords: np.ndarray,
                      cfg: RefineConfig, mesh: "Mesh" = None, *,
                      device_starts=None, n_atoms: int = 0, frozen0=None,
                      extra=None, device_out: bool = False) -> RefineResult:
    """Refine C candidate poses; start_coords is (C, N, 3) in Angstroms.

    Single-device runs are SEGMENTED: after ``segment_steps`` steps the
    frozen mask is pulled (one small sync) and the surviving candidates
    compact into a pow2-bucketed batch for the remaining steps — the
    median candidate converges several times earlier than the slowest one,
    so the compaction roughly halves the lane-steps while every candidate
    trajectory stays bitwise identical (all step math is lane-independent).

    mesh: optional device mesh; candidates shard across devices (each pose
    refinement is an independent scan), map replicated; segmentation is
    disabled (per-lane waste is distributed over the mesh).

    device_starts: fused-dock path — an already-framed (C, N, 3) DEVICE
    array of start poses (atom padding included); ``n_atoms`` gives the
    real atom count and ``frozen0`` an optional (C,) device mask of lanes
    frozen from step 0 (non-candidate padding lanes). No start coords
    cross the host boundary; the program chains onto the producing
    dispatch. ``extra``: arbitrary device arrays pulled alongside the
    refinement results in the one consolidated device_get (returned as
    ``RefineResult.extra``).

    device_out: return FULL-FRAME device arrays (rot/trans/coords/steps/
    failed, segments merged on device via _compiled_refine_merge) with NO
    host pull — for callers that chain further device programs onto the
    refinement results. ``converged`` is None and ``extra`` passes through
    untouched; the segmented path still pays its one frozen-mask sync."""
    if device_starts is not None:
        c = c_real = int(device_starts.shape[0])
        n = int(device_starts.shape[1])
        n_real = int(n_atoms)
        y0 = None
    else:
        c_real, n_real = start_coords.shape[:2]
        c = batch_bucket(max(c_real, 4), 4, mesh)
        n = bucket(n_real, 256)
        y0 = np.zeros((c, n, 3), dtype=np.float32)
        y0[:c_real, :n_real] = start_coords
        y0[:c_real, n_real:] = start_coords[:, :1]  # padded atoms masked out
        if c != c_real:
            y0[c_real:] = y0[0]
    atom_valid = np.zeros(n, dtype=bool)
    atom_valid[:n_real] = True

    def program(cc):
        return _compiled_refine(tuple(dmap.shape), cc, n, cfg.n_steps,
                                float(cfg.max_step), float(cfg.min_step),
                                cfg.batch_size,
                                getattr(cfg, "field_dtype", "float32"), mesh)

    # The driver stays free of eager device ops: every jnp indexing /
    # zeros / .at[].set() here would dispatch its own one-off program, and
    # each such program pays a compile at first execution. Arguments are
    # plain numpy (the executable transfers them, ~1-3 MB), segment state
    # is pulled ONCE, and all slicing/merging happens on host — bitwise
    # identical, since f32 device->host->device round trips are lossless.
    from ..utils.profiling import stage
    seg = int(getattr(cfg, "segment_steps", 128))
    cascade = (mesh is None and getattr(cfg, "cascade", True)
               and c_real >= 16)
    segmented = (not cascade and mesh is None and seg > 0
                 and cfg.n_steps > 2 * seg and c_real >= 16)
    with stage("refine.h2d"):
        map_d = dmap.device()
        # Segmented runs keep y0 on device: the inter-segment compaction
        # gathers from it without a host round trip.
        if device_starts is not None:
            y0_d = device_starts
        else:
            y0_d = jnp.asarray(y0) if segmented else y0
        if mesh is not None:
            ax = mesh_axis(mesh)
            # device_starts arrive replicated from the fused select
            # programs; the lane axis shards here (a local slice, no
            # cross-device traffic for an already-replicated array).
            y0_d = jax.device_put(jnp.asarray(y0_d),
                                  NamedSharding(mesh, P(ax, None, None)))
            map_d = jax.device_put(map_d, NamedSharding(mesh, P()))
        origin_h = np.asarray(dmap.origin, dtype=np.float32)
        voxsp = np.float32(dmap.voxsp)

    if cascade:
        fz0 = (frozen0 if frozen0 is not None
               else np.zeros((c,), dtype=bool))
        with stage("refine.seg1"):
            out = _compiled_refine_cascade(
                tuple(dmap.shape), c, n, cfg.n_steps, float(cfg.max_step),
                float(cfg.min_step), cfg.batch_size,
                getattr(cfg, "field_dtype", "float32"))(
                map_d, y0_d, atom_valid, origin_h, voxsp, fz0)
        rot_d, trans_d, coords_d, frozen_d, steps_d, failed_d = out
        if device_out:
            return RefineResult(rot=rot_d, trans=trans_d, coords=coords_d,
                                converged=None, steps=steps_d,
                                failed=failed_d, extra=extra)
        with stage("refine.pull"):
            out_h, extra_h = jax.device_get((out, extra))
        rot, trans, coords, frozen, steps, failed = [np.array(a)
                                                     for a in out_h]
        return RefineResult(
            rot=rot[:c_real],
            trans=trans[:c_real],
            coords=coords[:c_real, :n_real].astype(np.float64),
            converged=frozen[:c_real],
            steps=steps[:c_real],
            failed=failed[:c_real],
            extra=extra_h)

    def init_state(yy, cc):
        fz = (frozen0 if frozen0 is not None and cc == c
              else np.zeros((cc,), dtype=bool))
        return (np.zeros((cc, 3), np.float32),
                np.broadcast_to(np.eye(3, dtype=np.float32),
                                (cc, 3, 3)).copy(),
                np.full((cc,), cfg.max_step, np.float32), yy,
                fz, np.zeros((cc,), dtype=bool),
                np.zeros((cc,), np.int32))

    stop1 = seg if segmented else cfg.n_steps
    with stage("refine.seg1"):
        out = program(c)(map_d, y0_d, atom_valid, origin_h, voxsp,
                         *init_state(y0_d, c), np.int32(0), np.int32(stop1))

    if segmented:
        (rot_d, trans_d, coords_d, frozen_d, steps_d, failed_d, ssize_d,
         prev_d) = out
        with stage("refine.sync1"):
            frozen = np.array(jax.device_get(frozen_d))   # tiny sync
        active = np.nonzero(~frozen[:c_real])[0]
        out2 = None
        if len(active):
            c2 = min(_pow2_bucket(len(active)), c)
            ix = np.full(c2, active[0], np.int64)
            ix[:len(active)] = active
            with stage("refine.seg2"):
                (y0c, transc, rotc, ssizec, prevc, frozenc, failedc,
                 stepsc) = _compiled_refine_compact(c, c2, n)(
                    ix.astype(np.int32), y0_d, trans_d, rot_d, ssize_d,
                    prev_d, frozen_d, failed_d, steps_d)
                out2 = program(c2)(
                    map_d, y0c, atom_valid, origin_h, voxsp, transc, rotc,
                    ssizec, prevc, frozenc, failedc, stepsc,
                    np.int32(seg), np.int32(cfg.n_steps))
        if device_out:
            if out2 is not None:
                (rot2_d, trans2_d, coords2_d, _fz2, steps2_d, failed2_d,
                 _ss2, _pv2) = out2
                k = len(active)
                ix_put = np.full(c2, c, np.int32)   # pad rows drop
                ix_put[:k] = active
                rot_d, trans_d, coords_d, steps_d, failed_d = \
                    _compiled_refine_merge(c, c2, n)(
                        ix_put, rot_d, trans_d, coords_d, steps_d, failed_d,
                        rot2_d, trans2_d, coords2_d, steps2_d, failed2_d)
            return RefineResult(rot=rot_d, trans=trans_d, coords=coords_d,
                                converged=None, steps=steps_d,
                                failed=failed_d, extra=extra)
        # One consolidated pull of both segments' results.
        with stage("refine.pull"):
            pulled = jax.device_get(
                ((rot_d, trans_d, coords_d, steps_d, failed_d), out2,
                 extra))
        extra_h = pulled[2]
        (rot, trans, coords, steps, failed) = [np.array(a)
                                               for a in pulled[0]]
        if out2 is not None:
            (rot2, trans2, coords2, frozen2, steps2, failed2, _,
             _) = pulled[1]
            k = len(active)
            ia = ix[:k]
            rot[ia] = rot2[:k]
            trans[ia] = trans2[:k]
            coords[ia] = coords2[:k]
            frozen[ia] = frozen2[:k]
            steps[ia] = steps2[:k]
            failed[ia] = failed2[:k]
    else:
        if device_out:
            (rot_d, trans_d, coords_d, frozen_d, steps_d, failed_d, _ss,
             _pv) = out
            return RefineResult(rot=rot_d, trans=trans_d, coords=coords_d,
                                converged=None, steps=steps_d,
                                failed=failed_d, extra=extra)
        # One consolidated pull: every np.asarray would be its own
        # device-to-host round trip.
        with stage("refine.pull"):
            out_h, extra_h = jax.device_get((out, extra))
            (rot, trans, coords, frozen, steps, failed, _ssize,
             _prev) = out_h
    return RefineResult(
        rot=rot[:c_real],
        trans=trans[:c_real],
        coords=coords[:c_real, :n_real].astype(np.float64),
        converged=frozen[:c_real],
        steps=steps[:c_real],
        failed=failed[:c_real],
        extra=extra_h)
