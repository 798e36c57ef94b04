"""Full describe pipeline: density grid -> descriptor set.

Replaces MaD._describe_struct (mad/MaD.py:358-368): scale space -> detect ->
orient -> describe, per octave, then compaction of the fixed-width oriented
lanes into a dense descriptor table (the reference builds a Python list of
DensityFeature objects; here the result is a struct-of-arrays on host).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import MadConfig, bucket
from ..core.grid import DensityGrid
from ..core.structure import Structure
from ..ops.simulate import simulate_density
from ..ops.scalespace import iter_lazy_octaves
from ..ops.detect import detect_anchors
from ..ops.orient import orient_anchors
from ..ops.describe import describe_anchors
from ..utils.profiling import stage
from ..utils import sanitize
from ..utils.warmup import warmable as _warmable
import functools as _functools


# ---------------------------------------------------------------------------
# Speculative frame sizing. The fused chain runs at STATIC (anchor, lane)
# frames; octaves that overflow redo at the next power-of-2 rung instead of
# the full-capacity frame (8x the device work for a 15 % overflow). The
# measured rung is remembered per (name, grid shape) — in process and in a
# small JSON next to the persistent XLA cache — so steady-state passes and
# warm processes run exactly ONE right-sized chain, no redo.
# ---------------------------------------------------------------------------

_frame_lock = __import__("threading").Lock()
_frame_mem: Optional[dict] = None
# Frames ADOPTED by this process, keyed like the persistent memory. A
# frame-memory update written mid-process (right-sizing at the end of a
# pass) must only affect the NEXT process: adopting it mid-process would
# recompile the whole chain at the new frame on the very next pass — a
# fresh compile paid inside what should be a warm pass.
_frame_adopted: dict = {}


def _frames_adopt(key: str, default):
    """The frame this process uses for ``key``: first call resolves from
    the persistent memory (or ``default``) and pins it for the process."""
    with _frame_lock:
        if key not in _frame_adopted:
            _frame_adopted[key] = _frames_load().get(key) or tuple(default)
        return _frame_adopted[key]


def _frames_repin(key: str, caps) -> None:
    """Re-pin the process-local frame (overflow redos compile the larger
    frame anyway, so later calls should keep using it)."""
    with _frame_lock:
        _frame_adopted[key] = tuple(int(c) for c in caps)


def _frame_path() -> str:
    import os
    from ..core.config import cache_root
    return os.path.join(cache_root(), "frame_memory.json")


def _frames_load() -> dict:
    global _frame_mem
    if _frame_mem is None:
        import json
        try:
            with open(_frame_path()) as f:
                _frame_mem = {k: tuple(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            _frame_mem = {}
    return _frame_mem


def _frames_get(key: str):
    with _frame_lock:
        return _frames_load().get(key)


def _frames_put(key: str, caps) -> None:
    import json, os
    with _frame_lock:
        mem = _frames_load()
        if mem.get(key) == caps:
            return
        mem[key] = tuple(int(c) for c in caps)
        try:
            path = _frame_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({k: list(v) for k, v in mem.items()}, f)
            os.replace(tmp, path)
        except OSError:
            pass


def _rung(n: int, lo: int, hi: int) -> int:
    """Frame rung holding n with ~25 % headroom at 512 granularity,
    clamped to [lo, hi]. Finer than power-of-2 ladders: a measured 2350
    lanes runs at 3072, not 4096 — the orientation/descriptor work scales
    linearly with the frame, and the headroom absorbs run-to-run count
    jitter without an overflow redo."""
    if n <= lo:
        return lo
    p = -(-int(n * 1.25) // 512) * 512
    return min(max(p, lo), hi)


@dataclass
class DescriptorSet:
    """Dense descriptor table for one structure (host arrays).

    Layout matches the reference h5 schema (mad/MaD.py:848-859): ``desc`` is
    (N, subregions*subeqsp) int counts; ``info`` columns are
    [index, main_bin, sec_bin, octave, eqsp_size, subeqsp_size].
    """

    desc: "np.ndarray"        # (>=N, D) int16 counts (may be device; rows
                              # beyond ``n`` are zero bucket padding)
    desc_norm: "np.ndarray"   # (>=N, D) float32 unit rows (zero pads)
    coords: np.ndarray        # (N, 3) float32 voxel coords in own octave
    map_coords: np.ndarray    # (N, 3) float64 on-lattice coords (A)
    subv_coords: np.ndarray   # (N, 3) float64 subvoxel coords (A)
    rfinal: np.ndarray        # (N, 3, 3) float32
    octave: np.ndarray        # (N,) int32
    anchor_id: np.ndarray     # (N,) int32 global anchor index
    main_bin: np.ndarray      # (N,) int32
    sec_bin: np.ndarray       # (N,) int32
    eqsp_size: int = 112
    subeqsp_size: int = 16
    name: str = ""
    n_rows: Optional[int] = None   # real row count; device desc frames are
                                   # 128-bucketed so their shapes (and the
                                   # programs consuming them) stay stable
                                   # across runs

    @property
    def n(self) -> int:
        return self.n_rows if self.n_rows is not None else self.desc.shape[0]

    def unique_anchor_coords(self, rows: Optional[np.ndarray] = None
                             ) -> np.ndarray:
        """Unique subvoxel anchor coordinates (sorted, np.unique parity with
        mad/MaD.py:427-428)."""
        c = self.subv_coords if rows is None else self.subv_coords[rows]
        return np.unique(c, axis=0)


# An octave whose REAL voxel count is at or below this runs the whole
# describe chain as ONE program, with its LoG and gradient fields resident
# together. Larger octaves keep the streamed split (LoG freed before the
# gradient builds, bf16 gate). Derivation: the fused chain compiles to
# 30.2 B per real octave voxel on an H100 (bench map octave 0,
# 581x587x559, memory_analysis: 5.63 GB temp); one chain may take half of
# JAX's default 60 GB pool (75 % of an 80 GB card), since a second
# describe chain can run beside it: 30e9 / 30 = 1e9 voxels.
FUSE_OCTAVE_VOXELS = 1_000_000_000


@_functools.lru_cache(maxsize=32)
@_warmable
def _compiled_octave_chain(dims: tuple, sig_init: float, sig_presmooth: float,
                           up: bool, truncate: float, real_shape: tuple,
                           threshold: float, exclude_border: int,
                           max_offset: float, n_iter: int, capacity: int,
                           spec_k: int, radius: int, eqsp_size: int,
                           max_main: int, max_sec: int, ori_cutoff: float,
                           gw_sig: float, subeqsp_size: int, subregions: int,
                           dsc_cutoff: float, zero_magn: float, lane_cap: int,
                           dsc_radius: int = 0, donate: bool = False,
                           nan_watch: bool = False):
    """ONE program for a whole octave: LoG + detection + anchor compaction
    -> gradient field -> orientation + lane compaction -> descriptors.

    The streamed path dispatches four programs per octave and frees the
    LoG field before the gradient builds; the fused chain is one dispatch
    for octaves whose LoG+gradient working set fits device memory
    (FUSE_OCTAVE_VOXELS). Bodies are the SAME closures the split
    factories jit (ops.scalespace._log_detect_body/_grad_body,
    ops.orient._orient_bodies, ops.describe._describe_body), so results
    are identical row for row."""
    from ..ops.scalespace import _log_detect_body, _grad_body
    from ..ops.orient import _orient_bodies
    from ..ops.describe import _describe_body

    ld = _log_detect_body(dims, sig_init, sig_presmooth, up, truncate,
                          real_shape, threshold, exclude_border, max_offset,
                          n_iter, capacity, spec_k)
    gb = _grad_body(dims, sig_init, sig_presmooth, up, truncate, "float32")
    grad_shape = tuple(2 * s - 1 for s in dims) if up else tuple(dims)
    stride = 2 if up else 1
    _, ofu = _orient_bodies(grad_shape, real_shape, stride, radius,
                            eqsp_size, max_main, max_sec, ori_cutoff, gw_sig,
                            128, lane_cap)
    db = _describe_body(grad_shape, real_shape, up, dsc_radius or radius,
                        subeqsp_size, subregions, dsc_cutoff, zero_magn, 128)

    def chain(vol):
        coords_c, valid_c, order_a, subvox, n_anch = ld(vol)
        gradf = gb(vol)
        (mains, secs, rfin_l, lane_ok, lane_anchor, lane_main, lane_sec,
         coords_l, n_valid) = ofu(gradf, coords_c, valid_c)
        descs, ok = db(gradf, coords_l, rfin_l, lane_ok)
        out = (descs, (n_anch, n_valid),
               (ok & lane_ok, lane_anchor, lane_main, lane_sec, coords_l,
                rfin_l, subvox, mains, secs, order_a))
        if nan_watch:
            # Stage-mode sanitizer: the gradient field never leaves the
            # fused program, so its finiteness flag rides along instead
            # (utils/sanitize.watch_flag).
            return out + (jnp.all(jnp.isfinite(gradf)),)
        return out

    return jax.jit(chain, donate_argnums=(0,) if donate else ())


@_functools.lru_cache(maxsize=32)
@_warmable
def _compiled_gather_norm(lane_caps: tuple, kb: int):
    """Fused keep-gather + octave concatenation + L2 normalization: one
    program turns the per-octave (lane_cap, D) descriptor frames into the
    final 128-bucketed (kb, D) int16 table and its unit-row float32 view,
    rows beyond the real count zeroed. Replaces the per-octave eager
    gathers / concatenate / norm whose shapes depended on the run's exact
    keep counts — each of those dispatched a one-off program that paid a
    compile at first execution; the bucketed frames here make the program
    shapes stable across runs, so the warm manifest replays them."""
    import jax
    import jax.numpy as jnp

    n_oct = len(lane_caps)

    def run(*args):
        descs, idx, mask = args[:n_oct], args[n_oct], args[n_oct + 1]
        out = None
        for o in range(n_oct):
            g = descs[o][jnp.clip(idx[o], 0, lane_caps[o] - 1)]
            g = jnp.where(mask[o][:, None], g, 0).astype(jnp.int16)
            out = g if out is None else out + g     # masks are disjoint
        norm = out.astype(jnp.float32)
        lens = jnp.linalg.norm(norm, axis=1, keepdims=True)
        norm = jnp.where(lens > 0, norm / jnp.where(lens > 0, lens, 1.0),
                         norm)
        return out, norm

    return jax.jit(run)


def describe_grid(grid: DensityGrid, cfg: MadConfig, name: str = "",
                  mesh=None, _caps=None) -> DescriptorSet:
    """Run the full anchor/orientation/descriptor chain on a density grid.

    Single device: the FUSED path — per octave, exactly three program
    dispatches (LoG+detect+anchor-compaction, gradient, orientation+lane-
    compaction) plus the descriptor program, with STATIC speculative
    capacities and ZERO per-octave host syncs; anchor/lane counts return
    asynchronously and are checked in the one consolidated pull at the
    end. Octaves that overflow the speculative frames (dense maps) redo
    the whole chain at full capacity (``_caps`` recursion). The static
    frames collapse the per-run capacity buckets into one compiled
    program per (shape, octave), which the AOT manifest replays exactly.

    mesh: optional device mesh — CAPACITY mode (multi-chip): the LoG and
    gradient volumes stay x-slab-sharded through every stage; no device
    ever materializes a full field. Detection merges per-slab top-K peak
    lists into a replicated anchor table (tiny); orientation and
    description run the same kernels per device on the anchors/lanes whose
    patches that slab owns, gathering from halo-extended local blocks
    (parallel/volume.halo_extend). Results equal the single-device run
    row for row."""
    from ..ops.orient import _compiled_orient

    det_cfg = cfg.detect
    full_k = det_cfg.max_anchors
    full_l = min(bucket(cfg.describe.max_descriptors, 128),
                 full_k * cfg.orient.max_main * cfg.orient.max_sec)
    frame_key = f"{name or grid.name}|{tuple(grid.shape)}"
    default = (min(512, full_k),
               min(bucket(cfg.describe.static_lanes, 128), full_l))
    if _caps is not None:
        spec_k, lane_cap = _caps
    elif mesh is not None:
        spec_k, lane_cap = default
    else:
        spec_k, lane_cap = _frames_adopt(frame_key, default)
    spec_k, lane_cap = min(spec_k, full_k), min(lane_cap, full_l)
    radius = (cfg.orient.patch_size - cfg.orient.patch_size % 2) // 2

    rows = []
    pending = []
    anchor_base = 0
    origin = grid.origin
    gen = iter_lazy_octaves(grid, cfg.scalespace, cfg.shape_bucket, mesh)
    oi = -1
    while True:
        # Octaves stream one at a time so each one's volumes are freed
        # before the next builds (peak memory = one octave's working set).
        with stage("scalespace"):
            nxt = next(gen, None)
        if nxt is None:
            break
        origin, octv = nxt
        oi += 1
        upsampled = octv.voxsp < grid.voxsp
        if mesh is not None:
            with stage("detect"):
                log_vol = octv.log()
                sanitize.watch(f"scalespace.log[o{oi}]", log_vol)
                anch = detect_anchors(log_vol, octv.real_shape, det_cfg,
                                      mesh=mesh)
                sanitize.watch(f"detect[o{oi}]", anch.subvox)
                del log_vol
            out = _describe_octave_mesh(octv, anch, upsampled, cfg, mesh)
            if out is not None:
                out.update(oi=oi, voxsp=octv.voxsp, origin=origin,
                           base=anchor_base)
                pending.append(out)
            anchor_base += anch.capacity
            del octv, anch
            continue

        n_real = 1
        for s in octv.real_shape:
            n_real *= int(s)
        if n_real <= FUSE_OCTAVE_VOXELS:
            # Whole-octave fused chain: ONE dispatch for LoG+detect+grad+
            # orient+describe (identical bodies, identical rows; the LoG
            # and gradient fields coexist inside the program, which the
            # voxel gate bounds).
            with stage("describe"):
                dims_a, s_i, s_p, up_a, tr = octv._args
                dsc_radius = (cfg.describe.patch_size
                              - cfg.describe.patch_size % 2) // 2
                dims_vox = 1
                for s in dims_a:
                    dims_vox *= int(s)
                nan_watch = sanitize.mode() == "stage"
                fn = _compiled_octave_chain(
                    tuple(dims_a), float(s_i), float(s_p), bool(up_a),
                    float(tr), tuple(octv.real_shape),
                    float(det_cfg.threshold_abs),
                    int(det_cfg.exclude_border), float(det_cfg.max_offset),
                    int(det_cfg.newton_iters), int(det_cfg.max_anchors),
                    int(spec_k), int(radius), cfg.orient.eqsp_size,
                    cfg.orient.max_main, cfg.orient.max_sec,
                    float(cfg.orient.cutoff_magn), float(cfg.orient.gw_sig),
                    cfg.describe.subeqsp_size, cfg.describe.subregions,
                    float(cfg.describe.cutoff_magn),
                    float(cfg.describe.zero_magn), int(lane_cap),
                    dsc_radius=int(dsc_radius),
                    donate=bool(getattr(octv, "_final", False)
                                and dims_vox > 8_000_000),
                    nan_watch=nan_watch)
                if nan_watch:
                    descs, counts_d, dev, grad_ok = fn(octv._data)
                    sanitize.watch(f"detect[o{oi}]", dev[6])   # subvox
                    sanitize.watch_flag(f"scalespace.grad[o{oi}]", grad_ok)
                else:
                    descs, counts_d, dev = fn(octv._data)
                sanitize.watch(f"describe[o{oi}]", descs)
            pending.append(dict(
                oi=oi, voxsp=octv.voxsp, origin=origin, base=anchor_base,
                counts=counts_d, desc=descs, dev=dev))
            anchor_base += det_cfg.max_anchors
            del octv
            continue

        with stage("detect"):
            # Fused LoG + detection + valid-first anchor compaction; the
            # LoG volume lives only inside the program.
            (coords_c, valid_c, order_a, subvox,
             n_anch_d) = octv.log_detect(det_cfg, spec_k)
            sanitize.watch(f"detect[o{oi}]", subvox)
        with stage("orient"):
            grad_vol = octv.grad()
            sanitize.watch(f"scalespace.grad[o{oi}]", grad_vol)
            stride = 2 if upsampled else 1
            ofn = _compiled_orient(
                tuple(grad_vol.shape[:3]), tuple(octv.real_shape), stride,
                radius, cfg.orient.eqsp_size, cfg.orient.max_main,
                cfg.orient.max_sec, float(cfg.orient.cutoff_magn),
                float(cfg.orient.gw_sig), 128, lane_cap=lane_cap)
            (mains, secs, rfin_l, lane_ok, lane_anchor, lane_main,
             lane_sec, coords_l, n_valid_d) = ofn(grad_vol, coords_c,
                                                  valid_c)
            sanitize.watch(f"orient[o{oi}]", rfin_l)
        with stage("describe"):
            descs, ok = describe_anchors(
                grad_vol, coords_l, rfin_l, lane_ok, octv.real_shape,
                upsampled, cfg.describe)
        # Defer every host pull to one consolidated device_get after the
        # octave loop: one sync per describe pass instead of one per octave.
        pending.append(dict(
            oi=oi, voxsp=octv.voxsp, origin=origin, base=anchor_base,
            counts=(n_anch_d, n_valid_d),
            desc=descs,
            dev=(ok & lane_ok, lane_anchor, lane_main, lane_sec,
                 coords_l, rfin_l, subvox, mains, secs, order_a)))
        anchor_base += det_cfg.max_anchors
        del octv, grad_vol

    sanitize.flush()        # stage-mode NaN checks drain in one pull
    pulled = jax.device_get([(p["dev"], p.get("counts")) for p in pending])
    import os as _os
    if _os.environ.get("MAD_TPU_DEBUG_COUNTS"):
        print(f"MaD> describe[{name}]: (n_anch, n_valid) per octave = "
              f"{[tuple(map(int, c)) for _d, c in pulled if c is not None]}"
              f", frames = ({spec_k}, {lane_cap})")
    # Overflow check, folded into the one consolidated pull: octaves whose
    # anchor count beat the speculative frame, or whose valid-lane count
    # beat the static lane frame, redo the whole chain at the next
    # power-of-2 rung that holds the measured counts (NOT the full frame —
    # a 15 % lane overflow must not buy 8x the device work). The rung is
    # remembered per (name, shape) so only the very first process pays the
    # redo; recursion terminates because caps grow strictly to the full
    # frame.
    counts = [tuple(int(x) for x in c)
              for _dev, c in pulled if c is not None]
    if mesh is None and counts:
        max_a = max(c[0] for c in counts)
        max_l = max(c[1] for c in counts)
        if max_a > spec_k or max_l > lane_cap:
            new_k = _rung(max_a, min(512, full_k), full_k)
            # Lane counts were measured under a truncated anchor frame:
            # scale the estimate up by the anchor shortfall (x1.5 safety).
            est_l = max_l if max_a <= spec_k else int(
                max_l * max_a / max(spec_k, 1) * 1.5)
            new_l = _rung(est_l, 512, full_l)
            if new_k <= spec_k and new_l <= lane_cap:   # safety: must grow
                new_k, new_l = full_k, full_l
            _frames_put(frame_key, (new_k, new_l))
            redo = (max(new_k, spec_k), max(new_l, lane_cap))
            # The redo compiles the larger frame now; keep using it for the
            # rest of the process (mid-process shrink = fresh compile).
            _frames_repin(frame_key, redo)
            return describe_grid(grid, cfg, name=name, _caps=redo)
        if _caps is None:
            # Remember the right-sized rung (shrinks oversized defaults for
            # small structures, e.g. a subunit at the 2048-lane default).
            _frames_put(frame_key, (_rung(max_a, min(512, full_k), full_k),
                                    _rung(max_l, 512, full_l)))
    keeps = []
    for p, (host, _c) in zip(pending, pulled):
        (ok, lane_anchor, lane_main, lane_sec, coords_i, rfin, all_subvox,
         all_mains, all_secs, order_a_h) = host
        # Mesh capacities round up to whole shards; clip so a mesh run keeps
        # exactly the single-device overflow set.
        keep = np.nonzero(ok)[0][: cfg.describe.max_descriptors]
        # lane_anchor indexes the compacted buffer; translate back to the
        # original detect slot for subvox coords and stable anchor ids.
        orig_anchor = order_a_h[lane_anchor[keep]]
        subvox = all_subvox[orig_anchor]
        mains = all_mains[lane_anchor[keep], lane_main[keep]]
        secs = all_secs[
            lane_anchor[keep], lane_main[keep], lane_sec[keep]]
        keeps.append((p["desc"], keep))
        rows.append(dict(
            coords=coords_i[keep].astype(np.float32),
            map_coords=coords_i[keep] * p["voxsp"] + p["origin"],
            subv_coords=subvox.astype(np.float64) * p["voxsp"] + p["origin"],
            rfinal=rfin[keep].astype(np.float32),
            octave=np.full(len(keep), p["oi"], dtype=np.int32),
            anchor_id=(p["base"] + orig_anchor).astype(np.int32),
            main_bin=mains.astype(np.int32),
            sec_bin=secs.astype(np.int32),
        ))

    total = sum(len(k) for _d, k in keeps)
    if not rows or total == 0:
        z = np.zeros
        d = cfg.describe.subregions * cfg.describe.subeqsp_size
        return DescriptorSet(
            desc=z((0, d), np.int16), desc_norm=z((0, d), np.float32),
            coords=z((0, 3), np.float32), map_coords=z((0, 3)),
            subv_coords=z((0, 3)), rfinal=z((0, 3, 3), np.float32),
            octave=z(0, np.int32), anchor_id=z(0, np.int32),
            main_bin=z(0, np.int32), sec_bin=z(0, np.int32),
            eqsp_size=cfg.orient.eqsp_size,
            subeqsp_size=cfg.describe.subeqsp_size, name=name or grid.name)

    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    # Fused gather + concat + normalize at a 128-bucketed row frame: the
    # device descriptor table keeps a shape-stable program inventory (the
    # real row count travels as DescriptorSet.n_rows).
    kb = bucket(max(total, 128), 128)
    n_oct = len(keeps)
    idx = np.zeros((n_oct, kb), np.int32)
    msk = np.zeros((n_oct, kb), bool)
    at = 0
    for o, (_d, keep) in enumerate(keeps):
        idx[o, at:at + len(keep)] = keep
        msk[o, at:at + len(keep)] = True
        at += len(keep)
    lane_caps = tuple(int(d.shape[0]) for d, _k in keeps)
    desc, norm = _compiled_gather_norm(lane_caps, kb)(
        *[d for d, _k in keeps], idx, msk)
    return DescriptorSet(
        desc=desc, desc_norm=norm, n_rows=total,
        eqsp_size=cfg.orient.eqsp_size,
        subeqsp_size=cfg.describe.subeqsp_size,
        name=name or grid.name, **cat)


def _describe_octave_mesh(octv, anch, upsampled, cfg: MadConfig, mesh):
    """One octave of the capacity-mode (sharded-gather) describe chain.

    The gradient field stays x-slab-sharded; orientation and description
    select their own slab's work per device and emit per-shard selection
    orders. This helper composes those permutations back into the
    single-device ``pending`` schema — rows sorted by (global anchor slot,
    main, sec), exactly the single-device row order — so the consolidated
    host pull downstream is shared between both paths. Returns the pending
    dict (without octave metadata) or None when the octave has no valid
    lanes."""
    with stage("orient"):
        grad_vol = octv.grad()              # sharded; never replicated
        sanitize.watch("scalespace.grad[mesh]", grad_vol)
        # Per-shard anchor capacity, speculated small (most octaves carry a
        # few hundred valid anchors spread over the slabs) and redone at
        # full capacity when any slab owns more (shard_counts).
        spec_k = min(512, anch.capacity)
        ori = orient_anchors(grad_vol, anch, octv.real_shape, upsampled,
                             cfg.orient, mesh=mesh, shard_k=spec_k)
        n_valid, counts = jax.device_get(
            (jnp.sum(ori.valid), ori.shard_counts))
        if spec_k < anch.capacity and int(counts.max()) > spec_k:
            ori = orient_anchors(grad_vol, anch, octv.real_shape, upsampled,
                                 cfg.orient, mesh=mesh,
                                 shard_k=anch.capacity)
            n_valid = jax.device_get(jnp.sum(ori.valid))
        n_valid = int(n_valid)
    K2, M, S = ori.valid.shape              # K2 = n_shards * shard_k
    if n_valid == 0:
        del grad_vol
        return None
    MS = M * S
    lanes = K2 * MS
    cap = min(bucket(max(n_valid, 128), 128), anch.capacity * MS)
    if n_valid > cfg.describe.max_descriptors:
        cap = min(bucket(cfg.describe.max_descriptors, 128),
                  anch.capacity * MS)
    # Slot-major lane compaction: ordering by the GLOBAL anchor slot makes
    # the kept lane set (and its order) identical to the single-device
    # valid-first compaction, shard layout notwithstanding.
    flat_valid = ori.valid.reshape(-1)
    f = jnp.arange(lanes, dtype=jnp.int32)
    slot_of_lane = ori.anchor_idx[f // MS]
    big = jnp.int32(anch.capacity * MS)
    key = jnp.where(flat_valid, slot_of_lane * MS + f % MS, big)
    order_lane = jnp.argsort(key, stable=True)[:cap]
    coords_d = anch.coords[ori.anchor_idx[order_lane // MS]]
    rfin_d = ori.rfinal.reshape(-1, 3, 3)[order_lane]
    lane_ok_d = flat_valid[order_lane]
    with stage("describe"):
        descs, ok2, order2, _cnt = describe_anchors(
            grad_vol, coords_d, rfin_d, lane_ok_d, octv.real_shape,
            upsampled, cfg.describe, mesh=mesh, shard_l=cap)
    del grad_vol
    # Compose permutations: output row r holds input lane order2[r]; sort
    # rows back into slot-major order (single-device row order).
    j = order2
    flat = order_lane[j]
    la = flat // MS
    lm = (flat // S) % M
    ls = flat % S
    okr = ok2 & lane_ok_d[j]
    key_r = jnp.where(okr, ori.anchor_idx[la] * MS + flat % MS, big)
    rowperm = jnp.argsort(key_r, stable=True)
    return dict(
        desc=descs[rowperm],
        dev=(okr[rowperm], la[rowperm], lm[rowperm], ls[rowperm],
             coords_d[j[rowperm]], rfin_d[j[rowperm]], anch.subvox,
             ori.main_bin, ori.sec_bin, ori.anchor_idx))


# Threading gate for concurrent describe chains, as the SUM of the two
# largest jobs' PADDED BASE voxel counts; above it the chains run
# serially. Derivation: a fused chain takes 30.2 B per real up-octave
# voxel on an H100 (see FUSE_OCTAVE_VOXELS) and the up octave is ~8x the
# base, ~240 B per base voxel; two chains must share JAX's default 60 GB
# pool: 60e9 / 240 = 2.5e8, rounded down to 2.4e8 base voxels.
SERIAL_DESCRIBE_VOXELS = 240_000_000


def describe_many(jobs, max_workers: int = 2, voxels=None):
    """Run independent describe chains on a small thread pool.

    Each job is a zero-arg callable returning a DescriptorSet. The device
    serializes the actual kernels, but each chain's host work (octave
    prep, the consolidated pull, host-side row assembly) overlaps with the
    other chain's device work. Results return in job order.

    voxels: optional per-job working-volume estimates (padded grid voxel
    counts); when the two largest sum past SERIAL_DESCRIBE_VOXELS the jobs
    run serially — threading trades peak device memory for overlap."""
    import concurrent.futures as cf
    if voxels is not None and len(jobs) > 1:
        big = sorted(int(v) for v in voxels)[-2:]
        if sum(big) > SERIAL_DESCRIBE_VOXELS:
            max_workers = 1
    if len(jobs) <= 1 or max_workers <= 1:
        return [j() for j in jobs]
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = [ex.submit(j) for j in jobs]
        return [f.result() for f in futs]


def describe_structure(struct: Structure, resolution: float, voxsp: float,
                       cfg: MadConfig, isovalue: float = 0.0, name: str = "",
                       mesh=None) -> DescriptorSet:
    """PDB path of the describe pipeline: simulate density first
    (parity: MapSpace PDB_mode, mad/MapSpace.py:73-75)."""
    grid = simulate_density(struct, resolution, voxsp, isovalue=isovalue,
                            shape_bucket=cfg.shape_bucket)
    return describe_grid(grid, cfg, name=name or struct.source, mesh=mesh)
