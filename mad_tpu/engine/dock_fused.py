"""Fused dock-side selection: repeatability -> ordering -> greedy pose
clustering -> refinement start poses, in ONE device program.

The split path (engine/match.match_descriptors + engine/cluster.filter_pairs
+ engine/refine host loop) syncs with the host twice between the
similarity pull and the refinement dispatch and runs the greedy
clustering on host in between. Here the whole chain after the similarity
pull is one dispatch, the refinement launches on its device outputs with
no intermediate sync, and the cluster / candidate bookkeeping returns in
the refinement's consolidated pull.

Semantics are the split path's, re-derived in-program:
  * approximate repeatability for every pair via the dilated occupancy
    field, exact NN re-scoring of the ordering-critical top pairs
    (mad/MaD.py:440-448 via engine/match);
  * stable repeat-descending ordering (mad/MaD.py:480);
  * greedy cloud-RMSD clustering as a ``lax.scan`` over the ordered top
    ``n_samples`` pairs using the closed-form cloud RMSD from the anchor
    cloud's first/second moments (mad/MaD.py:500-521 via engine/cluster);
  * weight/repeatability gates + weight*repeat scoring (mad/MaD.py:526-551);
  * per-candidate refinement start pose (x0 - hi) @ R^T + lo
    (engine/docking._refine_and_merge).

The scan/gate math runs in f32 where the host path mixes f32/f64; decision
boundaries (cloud RMSD vs 10 A, 0.8-relative gates) sit far from f32
rounding at molecular scales, and the fused-vs-split equality tests pin the
resulting candidate sets (tests/test_dock_fused.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..parallel.mesh import mesh_axis, mesh_size, gather_invariant
from ..utils.warmup import warmable
from .match import _approx_repeat_body, _exact_repeat_body, _field_body


def _cluster_select_body(p: int, n_scan: int, c_cap: int, nb: int,
                         rmsd_cloud: float, wthresh: int, min_repeat: float,
                         repeat_frac: float):
    """Shared tail of the fused programs: given per-pair repeatabilities,
    order the pairs, greedily cluster the top ``n_scan``, gate + score the
    clusters, and emit the top ``c_cap`` candidates' refinement starts."""
    lanes = np.arange(p)
    slot_ids = np.arange(n_scan, dtype=np.int32)
    scan_ids = np.arange(n_scan, dtype=np.int32)
    cand_ids = np.arange(c_cap, dtype=np.int32)

    def run(rep_full, rot, hc, lc, n_rows, n_valid_scan, best_override,
            mu, M, x0):
        rep_m = jnp.where(lanes < n_rows, rep_full, -jnp.inf)
        order = jnp.argsort(-rep_m, stable=True)                  # (p,)

        oi = order[:n_scan]
        # A = R^T, b = lo - hi @ R^T: transformed cloud is X @ A + b
        # (engine/cluster.filter_pairs).
        A_ord = jnp.swapaxes(rot[oi], 1, 2)
        b_ord = lc[oi] - jnp.einsum("pd,pde->pe", hc[oi], A_ord)
        valid = scan_ids < jnp.minimum(n_valid_scan, n_rows)

        def step(carry, xs):
            CA, Cb, found_i, n_cl = carry
            A_i, b_i, v_i, i = xs
            D = CA - A_i[None]
            d = Cb - b_i[None]
            r2 = (jnp.einsum("cij,ik,ckj->c", D, M, D)
                  + 2.0 * jnp.einsum("j,cjk,ck->c", mu, D, d)
                  + jnp.sum(d * d, axis=-1))
            r2m = jnp.where(slot_ids < n_cl, r2, jnp.inf)
            jbest = jnp.argmin(r2m)
            new = (n_cl == 0) | (jnp.sqrt(jnp.maximum(r2m[jbest], 0.0))
                                 > rmsd_cloud)
            slot = jnp.where(new, n_cl, jbest)
            upd = (slot_ids == slot) & v_i & new
            CA = jnp.where(upd[:, None, None], A_i[None], CA)
            Cb = jnp.where(upd[:, None], b_i[None], Cb)
            found_i = jnp.where(upd, i, found_i)
            n_cl = n_cl + (new & v_i).astype(jnp.int32)
            assign = jnp.where(v_i, slot, jnp.int32(-1))
            return (CA, Cb, found_i, n_cl), assign

        init = (jnp.zeros((n_scan, 3, 3), jnp.float32),
                jnp.zeros((n_scan, 3), jnp.float32),
                jnp.zeros((n_scan,), jnp.int32), jnp.int32(0))
        (CA, Cb, found_i, n_cl), assign = lax.scan(
            step, init, (A_ord.astype(jnp.float32),
                         b_ord.astype(jnp.float32), valid, scan_ids))

        weights = jnp.zeros((n_scan,), jnp.int32).at[assign].add(
            1, mode="drop")                      # assign=-1 rows drop
        founded = slot_ids < n_cl
        rep_ord = rep_full[oi]
        rep_found = rep_ord[found_i]
        best = jnp.where(best_override > 0.0, best_override,
                         rep_full[order[0]])
        rep_thresh = jnp.maximum(jnp.float32(min_repeat),
                                 best * jnp.float32(repeat_frac))
        gate = founded & (weights >= wthresh) & (rep_found >= rep_thresh)
        score = jnp.where(gate, rep_found * weights.astype(jnp.float32),
                          -jnp.inf)
        cand_order = jnp.argsort(-score, stable=True)[:c_cap]
        n_cands = jnp.sum(gate.astype(jnp.int32))

        rows_c = oi[found_i[cand_order]]
        # start pose per candidate: (x0 - hi) @ R^T + lo
        # (engine/docking._refine_and_merge).
        starts = (jnp.einsum("nd,cde->cne", x0, jnp.swapaxes(rot[rows_c],
                                                             1, 2))
                  - jnp.einsum("cd,cde->ce", hc[rows_c],
                               jnp.swapaxes(rot[rows_c], 1, 2))[:, None]
                  + lc[rows_c][:, None])
        frozen0 = ~(gate[cand_order] & (cand_ids < n_cands))
        sel = (order, assign, found_i, weights, gate, cand_order, n_cands,
               rep_full)
        return sel, starts, frozen0

    return run


def _shard_slice(arr, ax: str, n_local: int):
    """This device's contiguous row block of a replicated array (shard_map
    helper: pair/lane work splits by ``axis_index`` so each device re-scores
    only its slice, then ``all_gather`` rebuilds the full axis)."""
    i0 = lax.axis_index(ax) * n_local
    return lax.dynamic_slice_in_dim(arr, i0, n_local, axis=0)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_dock_select(shape: Tuple[int, int, int], r_vox: int,
                          a_hi: int, a_lo: int, p: int, pe: int, n_scan: int,
                          c_cap: int, nb: int, anchor_dist: float,
                          rmsd_cloud: float, wthresh: int, min_repeat: float,
                          repeat_frac: float, mesh: Optional[Mesh] = None):
    """First-round program: dilated-field approximate repeatability for all
    pairs + exact re-scoring of the top ``pe`` + ordering + clustering +
    candidate starts, one dispatch.

    mesh: the SAME chain runs shard_map'ed — the approximate repeatability
    shards over the pair axis and the exact re-score over the top-``pe``
    axis (each a DP axis with anchor clouds replicated); the sequential
    cluster scan runs replicated on every device after an all_gather of the
    per-pair scores (tiny: p floats + p poses). Outputs are replicated, so
    the host bookkeeping is identical to the single-device path."""
    fb = _field_body(shape, r_vox)
    ab = _approx_repeat_body(shape, 256)
    eb = _exact_repeat_body(16, anchor_dist)
    cs = _cluster_select_body(p, n_scan, c_cap, nb, rmsd_cloud, wthresh,
                              min_repeat, repeat_frac)
    lanes = np.arange(p)
    elanes = np.arange(pe)
    eye = np.eye(3, dtype=np.float32)

    def select_tail(rep, rot, hc, lc, n_rows, n_exact, n_valid_scan, mu, M,
                    x0, exact_fn):
        """Exact re-score of the ordering-critical prefix
        (engine/match._compiled_select_exact semantics) + cluster/select.
        ``exact_fn(er, eh, el) -> (pe,)`` so the mesh variant can shard the
        re-score internally."""
        rep_m = jnp.where(lanes < n_rows, rep, -jnp.inf)
        top = jnp.argsort(-rep_m, stable=True)[:pe]
        er = jnp.where((elanes < n_exact)[:, None, None], rot[top], eye)
        erep = exact_fn(er, hc[top], lc[top])
        put = (elanes < n_exact) & (top < n_rows)
        rep_full = rep.at[jnp.where(put, top, p)].set(
            jnp.where(put, erep, 0.0), mode="drop")
        return cs(rep_full, rot, hc, lc, n_rows, n_valid_scan,
                  jnp.float32(-1.0), mu, M, x0)

    def run(lo_vox, lo_valid, hi_cloud, hi_valid, lo_cloud, origin,
            inv_voxsp, rot, hc, lc, n_rows, n_exact, n_valid_scan,
            mu, M, x0):
        field = fb(lo_vox, lo_valid)
        rep = ab(field, hi_cloud, hi_valid, origin, inv_voxsp, rot, hc, lc)
        return select_tail(
            rep, rot, hc, lc, n_rows, n_exact, n_valid_scan, mu, M, x0,
            lambda er, eh, el: eb(hi_cloud, hi_valid, lo_cloud, lo_valid,
                                  er, eh, el))

    if mesh is None:
        return jax.jit(run)

    ax = mesh_axis(mesh)
    pe_l = pe // mesh_size(mesh)

    def run_sharded(lo_vox, lo_valid, hi_cloud, hi_valid, lo_cloud, origin,
                    inv_voxsp, rot_s, hc_s, lc_s, n_rows, n_exact,
                    n_valid_scan, mu, M, x0):
        field = fb(lo_vox, lo_valid)              # replicated build
        rep_s = ab(field, hi_cloud, hi_valid, origin, inv_voxsp,
                   rot_s, hc_s, lc_s)             # this device's pair shard
        rep = gather_invariant(rep_s, ax, tiled=True)
        rot = gather_invariant(rot_s, ax, tiled=True)
        hc = gather_invariant(hc_s, ax, tiled=True)
        lc = gather_invariant(lc_s, ax, tiled=True)

        def exact_fn(er, eh, el):
            erep_l = eb(hi_cloud, hi_valid, lo_cloud, lo_valid,
                        _shard_slice(er, ax, pe_l),
                        _shard_slice(eh, ax, pe_l),
                        _shard_slice(el, ax, pe_l))
            return gather_invariant(erep_l, ax, tiled=True)

        return select_tail(rep, rot, hc, lc, n_rows, n_exact, n_valid_scan,
                           mu, M, x0, exact_fn)

    sel_specs = (P(),) * 8
    sm = shard_map(run_sharded, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P(), P(), P(),
                             P(ax, None, None), P(ax, None), P(ax, None),
                             P(), P(), P(), P(), P(), P()),
                   out_specs=(sel_specs, P(), P()),
                   check_vma=True)
    return jax.jit(sm)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_cached_select(p: int, n_scan: int, c_cap: int, nb: int,
                            rmsd_cloud: float, wthresh: int,
                            min_repeat: float, repeat_frac: float):
    """Cache-hit variant of _compiled_dock_select: repeatabilities arrive
    precomputed (a loaded matching cache, engine/docking.dock_structure), so
    the field/approximate/exact stages drop and ONE dispatch runs ordering +
    clustering + candidate starts directly. Outputs are replicated, so the
    same program serves mesh runs (the sequential scan is the whole body)."""
    cs = _cluster_select_body(p, n_scan, c_cap, nb, rmsd_cloud, wthresh,
                              min_repeat, repeat_frac)

    def run(rep_full, rot, hc, lc, n_rows, n_valid_scan, mu, M, x0):
        return cs(rep_full, rot, hc, lc, n_rows, n_valid_scan,
                  jnp.float32(-1.0), mu, M, x0)

    return jax.jit(run)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_rescue_select(a_hi: int, a_lo: int, pe: int, n_scan: int,
                            c_cap: int, nb: int, anchor_dist: float,
                            rmsd_cloud: float, wthresh: int,
                            min_repeat: float, repeat_frac: float,
                            mesh: Optional[Mesh] = None):
    """Rescue-round program: exact repeatability for the eligible row subset
    + ordering + clustering + candidate starts (the repeat gate stays
    relative to the FULL table's best, passed as ``best_override``).

    mesh: exact re-score shards over the row axis; the cluster scan runs
    replicated after an all_gather (see _compiled_dock_select)."""
    eb = _exact_repeat_body(16, anchor_dist)
    cs = _cluster_select_body(pe, n_scan, c_cap, nb, rmsd_cloud, wthresh,
                              min_repeat, repeat_frac)

    def run(hi_cloud, hi_valid, lo_cloud, lo_valid, rot, hc, lc, n_rows,
            best_override, mu, M, x0):
        erep = eb(hi_cloud, hi_valid, lo_cloud, lo_valid, rot, hc, lc)
        sel, starts, frozen0 = cs(erep, rot, hc, lc, n_rows, n_rows,
                                  best_override, mu, M, x0)
        return sel, starts, frozen0

    if mesh is None:
        return jax.jit(run)

    ax = mesh_axis(mesh)

    def run_sharded(hi_cloud, hi_valid, lo_cloud, lo_valid, rot_s, hc_s,
                    lc_s, n_rows, best_override, mu, M, x0):
        erep_l = eb(hi_cloud, hi_valid, lo_cloud, lo_valid, rot_s, hc_s,
                    lc_s)
        erep = gather_invariant(erep_l, ax, tiled=True)
        rot = gather_invariant(rot_s, ax, tiled=True)
        hc = gather_invariant(hc_s, ax, tiled=True)
        lc = gather_invariant(lc_s, ax, tiled=True)
        return cs(erep, rot, hc, lc, n_rows, n_rows, best_override, mu, M,
                  x0)

    sm = shard_map(run_sharded, mesh=mesh,
                   in_specs=(P(), P(), P(), P(),
                             P(ax, None, None), P(ax, None), P(ax, None),
                             P(), P(), P(), P(), P()),
                   out_specs=((P(),) * 8, P(), P()),
                   check_vma=True)
    return jax.jit(sm)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_dock_post(p: int, n_scan: int, c_cap: int, nb: int, a_hi: int,
                        a_lo: int, pe_r: int, n_scan_r: int, r_cap: int,
                        anchor_dist: float, rmsd_cloud: float, wthresh: int,
                        min_repeat: float, repeat_frac: float,
                        dedup_rmsd: float, hit_thresh: float,
                        mesh: Optional[Mesh] = None):
    """Post-refinement program: chains the inter-round host work of a dock
    rescue round onto the refinement's device outputs, so the main round's
    results never cross the host boundary before the rescue refinement
    dispatches. One dispatch covers:

      * composed refined pose per candidate lane (start pose x refinement
        rot/trans — the same composition the host computes in
        engine/docking._merge_refined; f32 here vs f64 there, a drift far
        below the inter-path pose differences the dock equality tests
        already absorb);
      * post-refine repeatability re-score: nearest map anchor per
        transformed subunit anchor (matmul-expansion argmin + a direct-
        difference distance recompute for the winner, killing the
        expansion's ~1e-3 A cancellation error; d <= voxsp*1.5 hit rule
        of mad/MaD.py:580-590);
      * greedy CA-RMSD dedup of the refined lanes in candidate order
      (merge-into-closest-accepted semantics of _merge_refined);
      * rescue eligibility: map anchors farther than anchor_dist from every
        accepted lane's atoms (the reference-extending rescue protocol,
        engine/docking docstring), ranked in table order;
      * the rescue round's exact re-score + ordering + clustering +
        refinement start poses (_compiled_rescue_select semantics).

    Returns bookkeeping for the host to rebuild Solution records after the
    ONE consolidated pull that follows the rescue refinement.

    mesh: the heavy per-lane / per-row stages shard (candidate re-score
    over the lane axis, rescue eligibility over the pair axis, the rescue
    exact re-score over its row axis); the sequential dedup/cluster scans
    run replicated on all_gathered inputs, so outputs are replicated and
    the host bookkeeping is path-independent."""
    eb = _exact_repeat_body(16, anchor_dist)
    cs = _cluster_select_body(pe_r, n_scan_r, r_cap, nb, rmsd_cloud,
                              wthresh, min_repeat, repeat_frac)
    lane_ids = np.arange(c_cap)
    pos_ids = np.arange(p)
    eye = np.eye(3, dtype=np.float32)

    def body(rot_m, trans_m, coords_m, failed_m,
             order, found_i, cand_order, n_cands, rep_full,
             rot_p, hc_p, lc_p, hi_cloud, hi_valid, lo_cloud, lo_valid,
             atom_valid, ca_mask, n_pairs, n_top_cap, mu, M, x0,
             lane_map_fn, pair_scan_fn, exact_fn):
        # Composed pose per lane: refine ran on y0 = (x0 - hi) @ Rc^T + lo,
        # so coords = x0 @ (Rc^T rot) + ((b - center) rot + center + trans)
        # — the same composition formula the host path evaluates in f64
        # (_merge_refined).
        oi = order[:n_scan]
        rows_c = oi[found_i[cand_order]]
        A = jnp.swapaxes(rot_p[rows_c], 1, 2)
        b = lc_p[rows_c] - jnp.einsum("cd,cde->ce", hc_p[rows_c], A)
        av = atom_valid.astype(jnp.float32)
        n_at = jnp.maximum(jnp.sum(av), 1.0)
        y0c = jnp.einsum("nd,cde->cne", x0, A) + b[:, None]
        center = (jnp.sum(y0c * av[None, :, None], axis=1)
                  / n_at)                                       # (C, 3)
        Rb = jnp.einsum("cij,cjk->cik", A, rot_m)
        Tb = (jnp.einsum("cd,cde->ce", b - center, rot_m) + center
              + trans_m)
        s_a = (jnp.einsum("ad,cde->cae", hi_cloud, Rb)
               + Tb[:, None])                                   # (C, A, 3)

        # Repeatability re-score: matmul-expansion argmin, then a
        # direct-difference distance recompute for the winning pair — the
        # expansion loses ~1e-3 A to cancellation at map-coordinate
        # magnitudes; the recomputed distance is exact f32.
        lo_sq = jnp.sum(lo_cloud * lo_cloud, axis=-1)

        def lane_rescore(s):
            d2 = (jnp.sum(s * s, -1)[:, None] + lo_sq[None]
                  - 2.0 * s @ lo_cloud.T)
            d2 = jnp.where(lo_valid[None], d2, jnp.inf)
            nn = jnp.argmin(d2, axis=-1)
            dif = s - lo_cloud[nn]
            return jnp.sum(dif * dif, -1) <= jnp.float32(hit_thresh) ** 2

        hits = lane_map_fn(lane_rescore, s_a) & hi_valid[None]
        counts = jnp.sum(hits, axis=-1).astype(jnp.int32)

        # Greedy CA-RMSD dedup in candidate order (_merge_refined):
        # merge a lane into the closest already-accepted lane when the CA
        # RMSD is below dedup_rmsd; otherwise it founds a new solution.
        ca = (ca_mask & atom_valid).astype(jnp.float32)
        n_ca = jnp.maximum(jnp.sum(ca), 1.0)

        def rmsd_row(ci):
            d = coords_m - ci[None]
            return jnp.sqrt(jnp.sum(jnp.sum(d * d, -1) * ca[None], -1)
                            / n_ca)

        rmat = lax.map(rmsd_row, coords_m)                      # (C, C)
        valid_lane = (lane_ids < n_cands) & (~failed_m) & (counts > 0)

        def dedup_step(acc, i):
            row = jnp.where(acc, rmat[i], jnp.inf)
            j = jnp.argmin(row)
            merged = jnp.any(acc) & (row[j] < jnp.float32(dedup_rmsd))
            ok = valid_lane[i]
            acc = acc.at[i].set(ok & ~merged)
            return acc, jnp.where(ok & merged, j.astype(jnp.int32),
                                  jnp.int32(-1))

        accepted, merge_to = lax.scan(
            dedup_step, jnp.zeros(c_cap, bool),
            jnp.arange(c_cap, dtype=jnp.int32))
        n_acc = jnp.sum(accepted.astype(jnp.int32))

        # Rescue eligibility per table row: distance from the row's map
        # anchor to the nearest accepted-lane atom (direct differences —
        # no cancellation), strict > anchor_dist, table (repeat-desc)
        # order.
        lc_ord = lc_p[order]

        def dmin2_of(lc_rows):
            def elig_step(best_d2, j):
                d = lc_rows[:, None, :] - coords_m[j][None]
                d2 = jnp.sum(d * d, -1)
                d2 = jnp.where((atom_valid & accepted[j])[None], d2,
                               jnp.inf)
                return jnp.minimum(best_d2, jnp.min(d2, -1)), None

            # The carry derives from lc_rows so that, on a mesh, it varies
            # over the pair axis like the rows of its shard do.
            out, _ = lax.scan(
                elig_step,
                jnp.full_like(lc_rows[:, 0], jnp.inf, jnp.float32),
                jnp.arange(c_cap, dtype=jnp.int32))
            return out

        dmin2 = pair_scan_fn(dmin2_of, lc_ord)
        elig = ((dmin2 > jnp.float32(anchor_dist) ** 2)
                & (pos_ids < n_pairs) & (n_acc > 0))

        # First n_top_cap eligible rows in table order -> rescue frame.
        rank = jnp.cumsum(elig.astype(jnp.int32)) - 1
        takeable = elig & (rank < n_top_cap)
        n_top = jnp.sum(takeable.astype(jnp.int32))
        key = jnp.where(takeable, pos_ids, p + 1)
        top_rows = jnp.argsort(key)[:pe_r].astype(jnp.int32)
        rows_r = order[top_rows]
        rl = jnp.arange(pe_r)
        ok_r = rl < n_top
        rot_e = jnp.where(ok_r[:, None, None], rot_p[rows_r], eye)
        hc_e = jnp.where(ok_r[:, None], hc_p[rows_r], 0.0)
        lc_e = jnp.where(ok_r[:, None], lc_p[rows_r], 0.0)
        erep = exact_fn(rot_e, hc_e, lc_e)
        sel_r, starts_r, frozen0_r = cs(erep, rot_e, hc_e, lc_e, n_top,
                                        n_top, rep_full[order[0]], mu, M, x0)
        post = (hits, counts, accepted, merge_to, n_acc, top_rows, n_top)
        return post, sel_r, starts_r, frozen0_r

    if mesh is None:
        def run(rot_m, trans_m, coords_m, failed_m,
                order, found_i, cand_order, n_cands, rep_full,
                rot_p, hc_p, lc_p, hi_cloud, hi_valid, lo_cloud, lo_valid,
                atom_valid, ca_mask, n_pairs, n_top_cap, mu, M, x0):
            return body(
                rot_m, trans_m, coords_m, failed_m, order, found_i,
                cand_order, n_cands, rep_full, rot_p, hc_p, lc_p, hi_cloud,
                hi_valid, lo_cloud, lo_valid, atom_valid, ca_mask, n_pairs,
                n_top_cap, mu, M, x0,
                lane_map_fn=lax.map,
                pair_scan_fn=lambda f, rows: f(rows),
                exact_fn=lambda rot_e, hc_e, lc_e: eb(
                    hi_cloud, hi_valid, lo_cloud, lo_valid, rot_e, hc_e,
                    lc_e))

        return jax.jit(run)

    ax = mesh_axis(mesh)
    nd = mesh_size(mesh)
    c_l, p_l, pe_r_l = c_cap // nd, p // nd, pe_r // nd

    def run_sharded(rot_m_s, trans_m_s, coords_m_s, failed_m_s,
                    order, found_i, cand_order, n_cands, rep_full,
                    rot_p_s, hc_p_s, lc_p_s, hi_cloud, hi_valid, lo_cloud,
                    lo_valid, atom_valid, ca_mask, n_pairs, n_top_cap,
                    mu, M, x0):
        # Refinement outputs arrive sharded over the candidate-lane axis,
        # the match table over the pair axis; the sequential scans need the
        # full axes (tiny payloads), the heavy hooks re-shard internally.
        rot_m = gather_invariant(rot_m_s, ax, tiled=True)
        trans_m = gather_invariant(trans_m_s, ax, tiled=True)
        coords_m = gather_invariant(coords_m_s, ax, tiled=True)
        failed_m = gather_invariant(failed_m_s, ax, tiled=True)
        rot_p = gather_invariant(rot_p_s, ax, tiled=True)
        hc_p = gather_invariant(hc_p_s, ax, tiled=True)
        lc_p = gather_invariant(lc_p_s, ax, tiled=True)

        def lane_map_fn(f, s_a):
            out_l = lax.map(f, _shard_slice(s_a, ax, c_l))
            return gather_invariant(out_l, ax, tiled=True)

        def pair_scan_fn(f, lc_rows):
            out_l = f(_shard_slice(lc_rows, ax, p_l))
            return gather_invariant(out_l, ax, tiled=True)

        def exact_fn(rot_e, hc_e, lc_e):
            erep_l = eb(hi_cloud, hi_valid, lo_cloud, lo_valid,
                        _shard_slice(rot_e, ax, pe_r_l),
                        _shard_slice(hc_e, ax, pe_r_l),
                        _shard_slice(lc_e, ax, pe_r_l))
            return gather_invariant(erep_l, ax, tiled=True)

        return body(
            rot_m, trans_m, coords_m, failed_m, order, found_i, cand_order,
            n_cands, rep_full, rot_p, hc_p, lc_p, hi_cloud, hi_valid,
            lo_cloud, lo_valid, atom_valid, ca_mask, n_pairs, n_top_cap,
            mu, M, x0, lane_map_fn, pair_scan_fn, exact_fn)

    sm = shard_map(run_sharded, mesh=mesh,
                   in_specs=(P(ax, None, None), P(ax, None),
                             P(ax, None, None), P(ax),
                             P(), P(), P(), P(), P(),
                             P(ax, None, None), P(ax, None), P(ax, None),
                             P(), P(), P(), P(), P(), P(), P(), P(),
                             P(), P(), P()),
                   out_specs=((P(),) * 7, (P(),) * 8, P(), P()),
                   check_vma=True)
    return jax.jit(sm)


def cloud_moments(hi_cloud: np.ndarray):
    """First/second moments of the (real) subunit anchor cloud, computed on
    host in f64 and passed to the device scan as f32 (engine/cluster)."""
    mu = hi_cloud.mean(axis=0)
    M = (hi_cloud.T @ hi_cloud) / hi_cloud.shape[0]
    return mu.astype(np.float32), M.astype(np.float32)
