"""Descriptor matching + pose repeatability scoring.

Replaces MaD._match_dsc (mad/MaD.py:414-453):
  * cosine similarity between all (subunit, map) descriptor pairs — one
    device matmul instead of np.dot on host;
  * candidate pairs above cc_threshold selected into a static-capacity
    buffer via per-row + global top_k (the reference walks np.where output);
  * per pair, relative pose R = R_lo^T @ R_hi and repeatability = % of the
    subunit's (unique) anchor cloud landing within ``anchor_dist`` of a map
    anchor after the pose transform. The reference queries a cKDTree per
    pair in a Python loop; here a dilated occupancy field of the map anchors
    gives an O(A) approximate score for every pair at once, and the top
    ``exact_top`` pairs are re-scored with exact brute-force NN distances
    (batched matmul) so the ordering consumed by clustering is exact.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.config import MatchConfig, bucket
from ..parallel.mesh import batch_bucket, mesh_axis
from ..utils.profiling import stage
from ..utils import sanitize
from .pipeline import DescriptorSet
from ..utils.warmup import warmable


@dataclass
class MatchTable:
    """Per-pair match data, sorted by repeatability (descending)."""

    cc: np.ndarray            # (P,) descriptor cosine similarity
    repeat: np.ndarray        # (P,) repeatability %
    hi_idx: np.ndarray        # (P,) row into the subunit DescriptorSet
    lo_idx: np.ndarray        # (P,) row into the map DescriptorSet
    rot: np.ndarray           # (P, 3, 3) pose rotation R = R_lo^T R_hi
    hi_coord: np.ndarray      # (P, 3) subunit anchor of the pair (A)
    lo_coord: np.ndarray      # (P, 3) map anchor of the pair (A)
    hi_cloud: np.ndarray      # (A_hi, 3) unique subunit anchor coords (A)
    lo_cloud: np.ndarray      # (A_lo, 3) unique map anchor coords (A)

    @property
    def n(self) -> int:
        return self.cc.shape[0]

    def take(self, rows: np.ndarray, repeat: Optional[np.ndarray] = None
             ) -> "MatchTable":
        """Row-subset view (same clouds); optionally with re-scored
        repeatabilities for the taken rows."""
        return MatchTable(
            cc=self.cc[rows],
            repeat=self.repeat[rows] if repeat is None else repeat,
            hi_idx=self.hi_idx[rows], lo_idx=self.lo_idx[rows],
            rot=self.rot[rows], hi_coord=self.hi_coord[rows],
            lo_coord=self.lo_coord[rows],
            hi_cloud=self.hi_cloud, lo_cloud=self.lo_cloud)


# Precision of the descriptor-cosine matmul. It must keep cosines within
# 1e-4 of float64 so the 0.6 threshold selects the same pairs. On the GPU
# Precision.HIGH (like DEFAULT) compiles to a single-pass TF32 cuBLAS gemm,
# 5e-4 off on the bench descriptor sets and enough to flip pairs at the
# threshold; HIGHEST is a float32 gemm, 7e-7 off, and takes 0.24-0.36 ms
# for the bench's (361 x 4559 x 1024) product on an H100 (700 W).
SIMILARITY_PRECISION = lax.Precision.HIGHEST


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_similarity(dh: int, dl: int, row_cap: int, max_pairs: int,
                         threshold: float):
    def run(hi, lo):
        sim = jnp.dot(hi, lo.T, preferred_element_type=jnp.float32,
                      precision=SIMILARITY_PRECISION)
        k = min(row_cap, dl)
        vals, cols = lax.top_k(sim, k)                    # (dh, k)
        flat = vals.reshape(-1)
        gvals, gidx = lax.top_k(flat, min(max_pairs, flat.shape[0]))
        rows = gidx // k
        lcols = jnp.take_along_axis(
            cols.reshape(-1), gidx, axis=0)
        ok = gvals > threshold
        return gvals, rows.astype(jnp.int32), lcols.astype(jnp.int32), ok

    return jax.jit(run)


def _field_body(shape: Tuple[int, int, int], radius_vox: int):
    """Occupancy-of-map-anchors field dilated by a voxel sphere.

    Dilation = shift-OR over the sphere's voxel offsets (fused slice maxima
    run near memory speed; 3D single-channel convs do not, see
    ops/convolve.py)."""
    r = radius_vox
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    offsets = np.argwhere(np.sum(g * g, axis=0) <= r * r) - r  # (P, 3)

    def build(pos_vox, valid):
        occ = jnp.zeros(shape, dtype=jnp.float32)
        occ = occ.at[pos_vox[:, 0], pos_vox[:, 1], pos_vox[:, 2]].max(
            jnp.where(valid, 1.0, 0.0), mode="drop")
        padded = jnp.pad(occ, r)
        out = None
        for dx, dy, dz in offsets:
            sl = padded[r + dx: r + dx + shape[0],
                        r + dy: r + dy + shape[1],
                        r + dz: r + dz + shape[2]]
            out = sl if out is None else jnp.maximum(out, sl)
        return (out > 0.5).astype(jnp.int8)

    return build


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_field(shape: Tuple[int, int, int], radius_vox: int):
    return jax.jit(_field_body(shape, radius_vox))


def _approx_repeat_body(shape: Tuple[int, int, int], chunk: int):
    """Per-pair approximate repeatability over whatever pair slab arrives
    (the full axis single-device; one shard of it under shard_map)."""

    def run(field, hi_cloud, hi_valid, origin, inv_voxsp, rot, hi_coord,
            lo_coord):
        denom = jnp.maximum(jnp.sum(hi_valid), 1)

        def one_chunk(args):
            R, h, l = args
            # (c, A, 3): transformed cloud per pair in the chunk
            pts = jnp.einsum("cad,ced->cae", hi_cloud[None] - h[:, None], R) \
                + l[:, None]
            vox = jnp.round((pts - origin) * inv_voxsp).astype(jnp.int32)
            inb = jnp.all(
                (vox >= 0) & (vox < jnp.asarray(shape)), axis=-1)
            vox = jnp.clip(vox, 0, jnp.asarray(shape) - 1)
            hit = field[vox[..., 0], vox[..., 1], vox[..., 2]] > 0
            cnt = jnp.sum(hit & inb & hi_valid[None], axis=-1)
            return 100.0 * cnt / denom

        n_pairs = rot.shape[0]
        n_chunks = n_pairs // chunk
        out = lax.map(one_chunk, (
            rot.reshape(n_chunks, chunk, 3, 3),
            hi_coord.reshape(n_chunks, chunk, 3),
            lo_coord.reshape(n_chunks, chunk, 3)))
        return out.reshape(n_pairs)

    return run


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_approx_repeat(shape: Tuple[int, int, int], a_hi: int,
                            n_pairs: int, chunk: int,
                            mesh: Optional[Mesh] = None):
    run = _approx_repeat_body(shape, chunk)
    if mesh is None:
        return jax.jit(run)
    # Multi-chip: the SAME body runs per device on its pair shard (DP over
    # the embarrassingly parallel pair axis; field/cloud replicated).
    ax = mesh_axis(mesh)
    sm = shard_map(run, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P(),
                             P(ax, None, None), P(ax, None), P(ax, None)),
                   out_specs=P(ax))
    return jax.jit(sm)


def _exact_repeat_body(chunk: int, thresh: float):
    def run(hi_cloud, hi_valid, lo_cloud, lo_valid, rot, hi_coord, lo_coord):
        denom = jnp.maximum(jnp.sum(hi_valid), 1)
        lo_sq = jnp.sum(lo_cloud * lo_cloud, axis=-1)

        def one_chunk(args):
            R, h, l = args
            pts = jnp.einsum("cad,ced->cae", hi_cloud[None] - h[:, None], R) \
                + l[:, None]
            d2 = (jnp.sum(pts * pts, axis=-1)[..., None] + lo_sq[None, None]
                  - 2.0 * jnp.einsum("cad,ld->cal", pts, lo_cloud))
            d2 = jnp.where(lo_valid[None, None], d2, jnp.inf)
            dmin = jnp.min(d2, axis=-1)
            cnt = jnp.sum((dmin < thresh * thresh) & hi_valid[None], axis=-1)
            return 100.0 * cnt / denom

        n_pairs = rot.shape[0]
        n_chunks = n_pairs // chunk
        out = lax.map(one_chunk, (
            rot.reshape(n_chunks, chunk, 3, 3),
            hi_coord.reshape(n_chunks, chunk, 3),
            lo_coord.reshape(n_chunks, chunk, 3)))
        return out.reshape(n_pairs)

    return run


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_exact_repeat(a_hi: int, a_lo: int, n_pairs: int, chunk: int,
                           thresh: float, mesh: Optional[Mesh] = None):
    run = _exact_repeat_body(chunk, thresh)
    if mesh is None:
        return jax.jit(run)
    ax = mesh_axis(mesh)
    sm = shard_map(run, mesh=mesh,
                   in_specs=(P(), P(), P(), P(),
                             P(ax, None, None), P(ax, None), P(ax, None)),
                   out_specs=P(ax))
    return jax.jit(sm)


def _pad_rows(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_select_exact(p: int, pe: int):
    """Top-``pe`` selection feeding the exact re-score, fused into ONE
    program: padding-row masking, the stable ordering by approximate
    repeatability, and the gathers of the exact-kernel inputs. Replaces
    six one-off eager device ops whose deferred compiles dominated the
    matching stage's first pass on remote-compile backends (each eager
    dispatch compiles its own program at first execution there).
    ``n_rows``/``n_exact`` are dynamic scalars so one compile serves every
    pair count within the (p, pe) bucket."""
    import jax
    import jax.numpy as jnp

    lanes = np.arange(p)
    elanes = np.arange(pe)
    eye = np.eye(3, dtype=np.float32)

    def run(rep, rot, hc, lc, n_rows, n_exact):
        rep_m = jnp.where(lanes < n_rows, rep, -jnp.inf)
        top = jnp.argsort(-rep_m, stable=True)[:pe]
        er = jnp.where((elanes < n_exact)[:, None, None], rot[top], eye)
        return top, er, hc[top], lc[top]

    return jax.jit(run)


def match_pairs(map_set: DescriptorSet, sub_set: DescriptorSet,
                cfg: MatchConfig, mesh: Optional[Mesh] = None
                ) -> Optional[dict]:
    """Similarity stage shared by the split and fused docking paths: device
    cosine matmul + thresholded top-pair selection (ONE host pull), then the
    host-side pose data every consumer needs — per-pair rotation
    R = R_lo^T R_hi, anchor coords, and the unique anchor clouds
    (mad/MaD.py:414-438). Returns None when no pair clears the threshold."""
    dh = batch_bucket(max(sub_set.n, 128), 128, mesh)
    dl = bucket(max(map_set.n, 128), 128)

    def pad_dev(arr, n):
        # Host arrays (h5-cached sets) pad on host: the eager zeros+scatter
        # pair would dispatch two one-off programs per shape. Device tables
        # arrive 128-bucket-framed from describe (DescriptorSet.n_rows), so
        # the device branch is a no-op except under mesh batch padding.
        if isinstance(arr, np.ndarray):
            return jnp.asarray(_pad_rows(arr, n) if arr.shape[0] != n
                               else arr)
        a = jnp.asarray(arr)
        if a.shape[0] == n:
            return a
        if a.shape[0] > n:
            raise ValueError(f"descriptor frame {a.shape[0]} > bucket {n}")
        return jnp.zeros((n,) + a.shape[1:], a.dtype).at[: a.shape[0]].set(a)

    hi = pad_dev(sub_set.desc_norm, dh)   # device-resident descriptors
    lo = pad_dev(map_set.desc_norm, dl)
    if mesh is not None:
        ax = mesh_axis(mesh)
        hi = jax.device_put(hi, NamedSharding(mesh, P(ax, None)))
        lo = jax.device_put(lo, NamedSharding(mesh, P()))
    sim_fn = _compiled_similarity(dh, dl, cfg.row_cap, cfg.max_pairs,
                                  float(cfg.cc_threshold))
    with stage("match.similarity"):
        ccs, rows, cols, ok = jax.device_get(sim_fn(hi, lo))
    sanitize.check_host("match.similarity", ccs)
    ok = ok & (rows < sub_set.n) & (cols < map_set.n)
    keep = np.nonzero(ok)[0]
    if len(keep) == 0:
        return None
    ccs, rows, cols = ccs[keep], rows[keep], cols[keep]

    # Unique anchor clouds from matched descriptors (mad/MaD.py:427-428).
    hi_cloud = np.unique(sub_set.subv_coords[rows], axis=0)
    lo_cloud = np.unique(map_set.subv_coords[cols], axis=0)

    # Relative pose per pair: R = R_lo^T @ R_hi (mad/MaD.py:438).
    r_hi = sub_set.rfinal[rows]
    r_lo = map_set.rfinal[cols]
    rot = np.einsum("pji,pjk->pik", r_lo, r_hi)  # R_lo^T @ R_hi
    hi_coord = sub_set.subv_coords[rows]
    lo_coord = map_set.subv_coords[cols]
    return dict(ccs=ccs, rows=rows, cols=cols, rot=rot, hi_coord=hi_coord,
                lo_coord=lo_coord, hi_cloud=hi_cloud, lo_cloud=lo_cloud)


def _empty_table() -> MatchTable:
    e = np.zeros(0)
    e3 = np.zeros((0, 3))
    return MatchTable(cc=e, repeat=e, hi_idx=e.astype(int),
                      lo_idx=e.astype(int), rot=np.zeros((0, 3, 3)),
                      hi_coord=e3, lo_coord=e3, hi_cloud=e3, lo_cloud=e3)


def match_descriptors(map_set: DescriptorSet, sub_set: DescriptorSet,
                      grid_shape, grid_origin, voxsp: float,
                      cfg: MatchConfig, min_exact: int = 0,
                      mesh: Optional[Mesh] = None) -> MatchTable:
    """hi = subunit, lo = map (reference naming, mad/MaD.py:414).

    min_exact: clustering consumes the top pairs strictly by repeatability
    (mad/MaD.py:480), so the caller passes how many leading pairs its
    downstream ordering depends on; at least that many get exact NN
    re-scoring (raising cfg.exact_top when needed) so the consumed prefix is
    never approximate.

    mesh: optional device mesh. The similarity matmul runs with the subunit
    rows sharded across devices (GSPMD partitions the SAME compiled kernel;
    per-row top_k is shard-local, the global top-k reduces across devices)
    and the repeatability kernels run shard_map'ed over the pair axis.
    Results equal the single-device path (up to ties between equal
    similarities)."""
    pairs = match_pairs(map_set, sub_set, cfg, mesh)
    if pairs is None:
        return _empty_table()
    ccs, rows, cols = pairs["ccs"], pairs["rows"], pairs["cols"]
    rot, hi_coord, lo_coord = (pairs["rot"], pairs["hi_coord"],
                               pairs["lo_coord"])
    hi_cloud, lo_cloud = pairs["hi_cloud"], pairs["lo_cloud"]

    def put(arr, *spec):
        a = jnp.asarray(arr)
        if mesh is None:
            return a
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    ax = mesh_axis(mesh) if mesh is not None else None

    # Stage A: approximate repeatability for every pair via dilated field.
    p = batch_bucket(len(rows), 256, mesh)
    a_hi = bucket(hi_cloud.shape[0], 256)
    a_lo = bucket(lo_cloud.shape[0], 256)
    hi_cloud_p = _pad_rows(hi_cloud.astype(np.float32), a_hi)
    hi_valid = np.zeros(a_hi, bool)
    hi_valid[: hi_cloud.shape[0]] = True
    lo_cloud_p = _pad_rows(lo_cloud.astype(np.float32), a_lo)
    lo_valid = np.zeros(a_lo, bool)
    lo_valid[: lo_cloud.shape[0]] = True
    rot_p = _pad_rows(rot.astype(np.float32), p)
    rot_p[len(rows):] = np.eye(3)
    hc_p = _pad_rows(hi_coord.astype(np.float32), p)
    lc_p = _pad_rows(lo_coord.astype(np.float32), p)

    r_vox = max(1, int(round(cfg.anchor_dist / voxsp)))
    field_fn = _compiled_field(tuple(grid_shape), r_vox)
    lo_vox = np.clip(np.round(
        (lo_cloud_p - np.asarray(grid_origin, dtype=np.float32)) / voxsp
    ).astype(np.int32), 0, np.asarray(grid_shape) - 1)
    with stage("match.field"):
        field = field_fn(jnp.asarray(lo_vox), jnp.asarray(lo_valid))

    approx_fn = _compiled_approx_repeat(tuple(grid_shape), a_hi, p, 256,
                                        mesh)
    rot_d = put(rot_p, ax, None, None)
    hc_d = put(hc_p, ax, None)
    lc_d = put(lc_p, ax, None)
    with stage("match.repeat_approx"):
        rep_d = approx_fn(
            put(field), put(hi_cloud_p), put(hi_valid),
            put(np.asarray(grid_origin, dtype=np.float32)),
            jnp.float32(1.0 / voxsp), rot_d, hc_d, lc_d)

    # Stage B: exact re-scoring of the top pairs (ordering-critical set).
    # The selection and the gathered exact-kernel inputs stay on device so
    # stage A -> selection -> stage B dispatches without an intermediate
    # host sync; one consolidated pull returns both scores.
    if cfg.exact_top > 0 or min_exact > 0:
        # Selection count is mesh-independent (mesh only pads the kernel
        # inputs) so a mesh run rescopes the same set as a single device.
        want = max(cfg.exact_top, min_exact)
        n_exact = min(bucket(want, 64), bucket(len(rows), 64))
        pe = batch_bucket(n_exact, 64, mesh)
        # Padding rows (>= len(rows)) must not enter the top selection.
        if mesh is None:
            top_d, er, eh, el = _compiled_select_exact(p, pe)(
                rep_d, rot_d, hc_d, lc_d, np.int32(len(rows)),
                np.int32(n_exact))
        else:
            rep_m = jnp.where(jnp.arange(p) < len(rows), rep_d, -jnp.inf)
            rep_m = jax.device_put(rep_m, NamedSharding(mesh, P()))
            top_d = jnp.argsort(-rep_m, stable=True)[:pe]
            er = jnp.where((jnp.arange(pe) < n_exact)[:, None, None],
                           rot_d[top_d], jnp.eye(3, dtype=jnp.float32))
            eh, el = hc_d[top_d], lc_d[top_d]
            er = jax.device_put(er, NamedSharding(mesh, P(ax, None, None)))
            eh = jax.device_put(eh, NamedSharding(mesh, P(ax, None)))
            el = jax.device_put(el, NamedSharding(mesh, P(ax, None)))
        exact_fn = _compiled_exact_repeat(a_hi, a_lo, pe, 16,
                                          float(cfg.anchor_dist), mesh)
        with stage("match.repeat_exact"):
            erep_d = exact_fn(
                put(hi_cloud_p), put(hi_valid),
                put(lo_cloud_p), put(lo_valid), er, eh, el)
            rep, erep, top = jax.device_get((rep_d, erep_d, top_d))
        rep = rep[: len(rows)].copy()
        n_use = min(n_exact, len(rows))
        rep[top[:n_use]] = erep[:n_use]
    else:
        rep = np.asarray(rep_d)[: len(rows)]

    sanitize.check_host("match.repeat", rep)
    order = np.argsort(-rep, kind="stable")
    return MatchTable(
        cc=ccs[order], repeat=rep[order], hi_idx=rows[order],
        lo_idx=cols[order], rot=rot[order], hi_coord=hi_coord[order],
        lo_coord=lo_coord[order], hi_cloud=hi_cloud, lo_cloud=lo_cloud)


def exact_rescore(table: MatchTable, rows: np.ndarray, anchor_dist: float,
                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """Exact NN repeatability for an arbitrary row subset of ``table``.

    The rescue pass (engine/docking.py) reaches below the exact-scored
    prefix of the table, where repeatabilities are still the approximate
    dilated-field scores; it re-scores exactly the rows it is about to
    consume so the ordering it clusters on is never approximate."""
    if len(rows) == 0:
        return np.zeros(0, np.float32)
    a_hi = bucket(max(table.hi_cloud.shape[0], 256), 256)
    a_lo = bucket(max(table.lo_cloud.shape[0], 256), 256)
    hi_cloud_p = _pad_rows(table.hi_cloud.astype(np.float32), a_hi)
    hi_valid = np.zeros(a_hi, bool)
    hi_valid[: table.hi_cloud.shape[0]] = True
    lo_cloud_p = _pad_rows(table.lo_cloud.astype(np.float32), a_lo)
    lo_valid = np.zeros(a_lo, bool)
    lo_valid[: table.lo_cloud.shape[0]] = True
    pe = batch_bucket(len(rows), 64, mesh)
    er = _pad_rows(table.rot[rows].astype(np.float32), pe)
    er[len(rows):] = np.eye(3)
    eh = _pad_rows(table.hi_coord[rows].astype(np.float32), pe)
    el = _pad_rows(table.lo_coord[rows].astype(np.float32), pe)

    def put(arr, *spec):
        a = jnp.asarray(arr)
        if mesh is None:
            return a
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    ax = mesh_axis(mesh) if mesh is not None else None
    exact_fn = _compiled_exact_repeat(a_hi, a_lo, pe, 16,
                                      float(anchor_dist), mesh)
    with stage("match.repeat_exact"):
        return np.asarray(exact_fn(
            put(hi_cloud_p), put(hi_valid), put(lo_cloud_p), put(lo_valid),
            put(er, ax, None, None), put(eh, ax, None),
            put(el, ax, None)))[: len(rows)]
