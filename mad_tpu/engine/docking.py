"""Per-subunit docking: match -> filter -> refine -> score -> dedup.

Replaces MaD._match_filter_refine / _refine_filtered_solutions
(mad/MaD.py:371-411, 556-629), plus a rescue loop the reference does not
have: after the first round, descriptor pairs whose map anchor is not
explained by any accepted solution get a fresh clustering budget under the
same quality gates, recovering marginal copies whose pairs ranked below the
first-round n_samples cutoff.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
from scipy.spatial import cKDTree

from ..core.config import MadConfig, bucket
from ..core.grid import DensityGrid
from ..core.structure import Structure
from .score import ccc_structures
from .pipeline import DescriptorSet, _frames_adopt, _frames_put
from .match import (match_descriptors, match_pairs, exact_rescore,
                    MatchTable, _pad_rows)
from .cluster import filter_pairs, Candidate
from .refine import refine_candidates
from ..utils import sanitize
from ..utils.profiling import stage


@dataclass
class Solution:
    """One refined, deduplicated docking solution."""

    structure: Structure           # refined pose
    corresp_anchors: np.ndarray    # (K, 3) matched anchors post-refine
    repeat: float
    weight: int
    ccc: float
    members: List[np.ndarray] = field(default_factory=list)
    score: float = 0.0             # RWmCC = repeat * weight * ccc


def _refine_and_merge(candidates: List[Candidate], solutions: List[Solution],
                      sub_struct: Structure, dmap: DensityGrid,
                      table: MatchTable, cfg: MadConfig, mesh=None) -> int:
    """Refine candidate poses and merge them into ``solutions`` (CA-RMSD
    dedup with weight merging, mad/MaD.py:592-620). Returns the number of
    genuinely new solutions appended."""
    x0 = sub_struct.coords
    starts = np.stack([
        (x0 - c.hi_coord) @ c.rot.T + c.lo_coord for c in candidates
    ]).astype(np.float32)
    with stage("refine"):
        res = refine_candidates(dmap, starts, cfg.refine, mesh=mesh)
    return _merge_refined(res, candidates, solutions, sub_struct, dmap,
                          table, cfg)


def _merge_refined(res, candidates: List[Candidate],
                   solutions: List[Solution], sub_struct: Structure,
                   dmap: DensityGrid, table: MatchTable,
                   cfg: MadConfig) -> int:
    """Post-refinement host half: Kabsch re-pose, repeatability re-score,
    CA-RMSD dedup + weight merge. ``res`` rows beyond ``candidates`` are
    padding lanes (fused path) and are ignored."""
    # Re-scored repeatability after refinement (mad/MaD.py:580-590). The
    # refined map is the COMPOSITION of the candidate start pose with the
    # refinement's rot/trans — f64 on the same f32 inputs the device twin
    # (_compiled_dock_post) uses, so hit decisions cannot drift between
    # the host and fused-post paths. (A Kabsch re-fit of the refined
    # coordinates recovers the same transform up to f32 rounding.)
    x032 = sub_struct.coords.astype(np.float32).astype(np.float64)
    lo_tree = cKDTree(table.lo_cloud)
    thresh = dmap.voxsp * 1.5
    refined: List[tuple] = []
    for i, cand in enumerate(candidates):
        if res.failed is not None and res.failed[i]:
            continue  # numerically failed candidate (NaN guard)
        A = cand.rot.T.astype(np.float64)
        b = cand.lo_coord - cand.hi_coord.astype(np.float64) @ A
        center = (x032 @ A + b).mean(axis=0)
        R = np.asarray(res.rot[i], dtype=np.float64)
        t = np.asarray(res.trans[i], dtype=np.float64)
        s_a = ((table.hi_cloud @ A + b) - center) @ R + center + t
        d, _ = lo_tree.query(s_a, distance_upper_bound=thresh)
        hits = d <= thresh
        repeat = 100.0 * np.count_nonzero(hits) / table.hi_cloud.shape[0]
        if repeat <= 0:
            continue
        refined.append((res.coords[i], s_a[hits], repeat, cand.weight,
                        cand.members))

    n_new = 0
    for coords, corresp, repeat, weight, members in refined:
        struct = sub_struct.with_coords(coords)
        merged = False
        if solutions:
            rmsds = [struct.rmsd_ca_with(s.structure) for s in solutions]
            j = int(np.argmin(rmsds))
            if rmsds[j] < cfg.refine.dedup_rmsd:
                solutions[j].weight += weight
                solutions[j].members.extend(members)
                merged = True
        if not merged:
            solutions.append(Solution(
                structure=struct, corresp_anchors=corresp, repeat=repeat,
                weight=weight, ccc=0.0, members=list(members)))
            n_new += 1
    return n_new


def _candidates_from_select(table: MatchTable, hi_bins, lo_bins, assign,
                            found_i, weights, slot_order) -> List[Candidate]:
    """Rebuild the Candidate records the host clustering would have produced
    from the fused program's outputs. ``assign[i]`` is the cluster slot of
    the i-th pair of the (sorted) ``table``; ``found_i[slot]`` its founding
    row; ``slot_order`` the gated slots in weight*repeat order."""
    cands = []
    for slot in slot_order:
        slot = int(slot)
        row = int(found_i[slot])
        w = int(weights[slot])
        mem = np.nonzero(assign == slot)[0]
        members = [np.concatenate([table.hi_coord[i], table.lo_coord[i],
                                   [hi_bins[i], lo_bins[i]]]) for i in mem]
        rep = float(table.repeat[row])
        cands.append(Candidate(
            hi_coord=table.hi_coord[row], lo_coord=table.lo_coord[row],
            rot=table.rot[row], cc=float(table.cc[row]), weight=w,
            repeat=rep, score=rep * w, members=members))
    return cands


def _merge_rescue_round(res_r, sub_table, map_set, sub_set, solutions,
                        sub_struct, dmap, table, cfg, n_cands_r: int,
                        r_cap: int, assign_r, found_r, weights_r, gate_r,
                        cand_order_r) -> int:
    """Merge one rescue round's refined candidates into ``solutions``
    (shared by the device-chained round and the host-loop rounds).
    Overflowing rounds re-rank every gated cluster on host and redo the
    refinement through the split path; in-frame rounds consume the fused
    refinement's lanes directly. Returns the number of new solutions."""
    sub_hi = sub_set.main_bin[sub_table.hi_idx]
    sub_lo = map_set.main_bin[sub_table.lo_idx]
    if n_cands_r > r_cap:
        slots = np.nonzero(gate_r)[0]
        score = sub_table.repeat[found_r[slots]] * weights_r[slots]
        slot_order = slots[np.argsort(-score, kind="stable")]
        cands_r = _candidates_from_select(sub_table, sub_hi, sub_lo,
                                          assign_r, found_r, weights_r,
                                          slot_order)
        return _refine_and_merge(cands_r, solutions, sub_struct, dmap,
                                 table, cfg)
    slot_order = cand_order_r[:n_cands_r]
    cands_r = _candidates_from_select(sub_table, sub_hi, sub_lo, assign_r,
                                      found_r, weights_r, slot_order)
    res_slice = type(res_r)(
        rot=res_r.rot[:n_cands_r], trans=res_r.trans[:n_cands_r],
        coords=res_r.coords[:n_cands_r],
        converged=(None if res_r.converged is None
                   else res_r.converged[:n_cands_r]),
        steps=res_r.steps[:n_cands_r], failed=res_r.failed[:n_cands_r])
    return _merge_refined(res_slice, cands_r, solutions, sub_struct, dmap,
                          table, cfg)


def _dock_structure_fused(map_set: DescriptorSet, sub_set: DescriptorSet,
                          sub_struct: Structure, dmap: DensityGrid,
                          resolution: float, cfg: MadConfig, n_copies: int,
                          verbose: bool, on_filtered, mesh=None,
                          match_cache: str = None, frame_group: str = ""
                          ) -> List[Solution]:
    """Docking through the fused select programs: after the similarity
    pull, repeatability -> ordering -> clustering -> start poses run as ONE
    dispatch and the refinement chains onto its device outputs. With rescue
    rounds enabled, the first rescue round ALSO chains on device
    (_compiled_dock_post: re-score + dedup + eligibility + rescue selection
    + rescue refinement), so the whole two-round dock costs two
    segment-boundary syncs plus ONE consolidated pull. Candidate and table
    bookkeeping is reconstructed host-side from that pull; results match
    the split path (engine/dock_fused docstring).

    mesh: the SAME chain runs sharded — similarity rows, pair/lane axes and
    refinement candidates shard over the mesh (shard_map variants of the
    same fused programs; the sequential cluster scans run replicated after
    all_gathers of the tiny per-pair score/pose payloads). Host bookkeeping
    and results are identical to the single-device fused path.

    match_cache: optional h5 path. On a hit the MatchTable (pairs +
    repeatabilities) loads from it and the similarity/repeatability
    programs are skipped entirely — ordering + clustering + starts run as
    one small dispatch (_compiled_cached_select) and the refinement chains
    on as usual. On a miss the table computed by the select program is
    saved after the pull, so repeat runs stay on the fused path (the
    reference's matching cache, mad/MaD.py:386-399, without a split-path
    perf cliff)."""
    import os as _os
    import jax.numpy as jnp
    from .. import cache as _cache
    from ..parallel.mesh import batch_bucket
    from .dock_fused import (_compiled_dock_select, _compiled_dock_post,
                             _compiled_rescue_select,
                             _compiled_cached_select, cloud_moments)

    fc = cfg.filter
    mc = cfg.match
    n_samples = fc.n_samples * n_copies

    cached_table = None
    if match_cache and _os.path.exists(match_cache):
        cached_table = _cache.load_matching(match_cache)
        if verbose:
            print(f"MaD> Loaded matched descriptor pairs from {match_cache}")
        if cached_table.n == 0:
            return []
        ccs, rows, cols = (cached_table.cc, cached_table.hi_idx,
                           cached_table.lo_idx)
        rot, hi_coord, lo_coord = (cached_table.rot, cached_table.hi_coord,
                                   cached_table.lo_coord)
        hi_cloud, lo_cloud = cached_table.hi_cloud, cached_table.lo_cloud
        n_pairs = cached_table.n
    else:
        with stage("match"):
            pairs = match_pairs(map_set, sub_set, mc, mesh=mesh)
        if pairs is None:
            if verbose:
                print(f"MaD> 0 descriptor pairs above "
                      f"cc={mc.cc_threshold:.2f}")
            return []
        ccs, rows, cols = pairs["ccs"], pairs["rows"], pairs["cols"]
        rot, hi_coord, lo_coord = (pairs["rot"], pairs["hi_coord"],
                                   pairs["lo_coord"])
        hi_cloud, lo_cloud = pairs["hi_cloud"], pairs["lo_cloud"]
        n_pairs = len(rows)
    if verbose:
        print(f"MaD> {n_pairs} descriptor pairs above "
              f"cc={mc.cc_threshold:.2f}")

    # Static frames (mirroring engine/match.match_descriptors). Under a
    # mesh the sharded axes bucket per-device (batch_bucket) so every
    # device holds whole kernel chunks.
    p = batch_bucket(max(n_pairs, 256), 256, mesh)
    want = max(mc.exact_top, n_samples)
    n_exact = min(bucket(want, 64), bucket(n_pairs, 64))
    pe = batch_bucket(n_exact, 64, mesh)
    a_hi = bucket(hi_cloud.shape[0], 256)
    a_lo = bucket(lo_cloud.shape[0], 256)
    n_scan = bucket(max(min(n_samples, n_pairs), 64), 64)
    # Candidate-lane frame: remembered per structure pair (the measured
    # cluster counts are deterministic per system), 16-granular; an
    # overflow redoes the refinement through the host path this call and
    # right-sizes the NEXT process (pipeline frame-memory pattern). The
    # frame is ADOPTED once per process — a rung written at the end of one
    # pass must not change the next pass's program shapes (that would be a
    # fresh compile inside a warm pass).
    # The map shape is part of the key: systems that share structure NAMES
    # but not sizes (e.g. bench.py's north-star map vs stress_large.py's
    # 44 M-voxel map, both "bench_map") must not trade rungs — an oversized
    # adopted frame recompiles the warm programs AND buys linearly more
    # refinement gather work per pass.
    # Ensemble frames pass frame_group=<ensemble key>: all conformers of
    # one ensemble share ONE candidate-lane rung (their cluster counts are
    # near-identical — same subunit, smoothly deformed), so the dock-side
    # programs compile once per ensemble instead of once per conformer
    # (round-4 verdict item 6).
    shp = "x".join(str(int(s)) for s in dmap.shape)
    sub_key = frame_group or sub_set.name
    cap_key = f"dockc|{map_set.name}|{shp}|{sub_key}"
    c_cap = _frames_adopt(cap_key, (48,))[0]
    c_cap = int(min(max(c_cap, 16), n_scan))
    # Rescue rounds carry far fewer candidates (unexplained-density pairs
    # only) and the refinement's gather cost scales linearly with the lane
    # frame, so they get their own, smaller frame.
    rcap_key = f"dockr|{map_set.name}|{shp}|{sub_key}"
    r_cap = int(min(max(_frames_adopt(rcap_key, (16,))[0], 8), n_scan))
    if mesh is not None:
        # Lane frames shard over the mesh: round up so every device gets
        # whole lanes, and keep n_scan >= the (possibly grown) frame.
        c_cap = batch_bucket(c_cap, 16, mesh)
        r_cap = batch_bucket(r_cap, 8, mesh)
        n_scan = max(n_scan, c_cap, r_cap)
    nb = bucket(sub_struct.n_atoms, 256)
    n_atoms = sub_struct.n_atoms
    x0p = np.concatenate([
        sub_struct.coords,
        np.repeat(sub_struct.coords[:1], nb - n_atoms, axis=0)
    ]).astype(np.float32)
    mu, M = cloud_moments(hi_cloud)

    rot_p = _pad_rows(rot.astype(np.float32), p)
    rot_p[n_pairs:] = np.eye(3)
    hc_p = _pad_rows(hi_coord.astype(np.float32), p)
    lc_p = _pad_rows(lo_coord.astype(np.float32), p)
    hi_cloud_p = _pad_rows(hi_cloud.astype(np.float32), a_hi)
    hi_valid = np.zeros(a_hi, bool)
    hi_valid[: hi_cloud.shape[0]] = True
    lo_cloud_p = _pad_rows(lo_cloud.astype(np.float32), a_lo)
    lo_valid = np.zeros(a_lo, bool)
    lo_valid[: lo_cloud.shape[0]] = True
    origin_f = np.asarray(dmap.origin, dtype=np.float32)
    r_vox = max(1, int(round(mc.anchor_dist / dmap.voxsp)))
    lo_vox = np.clip(np.round(
        (lo_cloud_p - origin_f) / dmap.voxsp).astype(np.int32),
        0, np.asarray(dmap.shape) - 1)

    if cached_table is not None:
        # Cache hit: repeatabilities are already in the table (exact for
        # the ordering-critical prefix, like the miss path computes), so
        # the field/approx/exact programs drop; one small dispatch runs
        # ordering + clustering + starts on the loaded values.
        rep_p = np.zeros(p, np.float32)
        rep_p[:n_pairs] = cached_table.repeat
        with stage("match"):
            sel_fn = _compiled_cached_select(
                p, n_scan, c_cap, nb, float(fc.rmsd_cloud),
                int(fc.weight_threshold), float(fc.min_repeat),
                float(fc.repeat_frac))
            sel, starts, frozen0 = sel_fn(
                rep_p, rot_p, hc_p, lc_p, np.int32(n_pairs),
                np.int32(min(n_samples, n_pairs)), mu, M, x0p)
    else:
        with stage("match"):
            sel_fn = _compiled_dock_select(
                tuple(dmap.shape), r_vox, a_hi, a_lo, p, pe, n_scan, c_cap,
                nb, float(mc.anchor_dist), float(fc.rmsd_cloud),
                int(fc.weight_threshold), float(fc.min_repeat),
                float(fc.repeat_frac), mesh=mesh)
            sel, starts, frozen0 = sel_fn(
                lo_vox, lo_valid, hi_cloud_p, hi_valid, lo_cloud_p, origin_f,
                np.float32(1.0 / dmap.voxsp), rot_p, hc_p, lc_p,
                np.int32(n_pairs), np.int32(min(n_exact, n_pairs)),
                np.int32(min(n_samples, n_pairs)), mu, M, x0p)
    use_post = int(fc.rescue_rounds) >= 1
    with stage("refine"):
        res = refine_candidates(dmap, None, cfg.refine, mesh=mesh,
                                device_starts=starts, n_atoms=n_atoms,
                                frozen0=frozen0,
                                extra=None if use_post else sel,
                                device_out=use_post)

    main_h = post_h = sel_r_h = res_r = None
    if use_post:
        # Chain the inter-round work on device (_compiled_dock_post):
        # post-refine re-score + dedup + rescue eligibility/selection run
        # as one dispatch on the refinement's device outputs, and the
        # rescue refinement follows with no host boundary in between. ONE
        # consolidated pull then returns both rounds' results.
        pe_r = batch_bucket(max(n_samples, 64), 64, mesh)
        atom_valid = np.zeros(nb, bool)
        atom_valid[:n_atoms] = True
        ca_mask = np.zeros(nb, bool)
        if len(sub_struct.ca_idx):
            ca_mask[sub_struct.ca_idx] = True
        else:
            ca_mask[:n_atoms] = True      # rmsd_ca_with all-atom fallback
        with stage("rescue.rescore"):
            post_fn = _compiled_dock_post(
                p, n_scan, c_cap, nb, a_hi, a_lo, pe_r, pe_r, r_cap,
                float(mc.anchor_dist), float(fc.rmsd_cloud),
                int(fc.weight_threshold), float(fc.min_repeat),
                float(fc.repeat_frac), float(cfg.refine.dedup_rmsd),
                float(dmap.voxsp * 1.5), mesh=mesh)
            post_d, sel_r_d, starts_r, frozen0_r = post_fn(
                res.rot, res.trans, res.coords, res.failed,
                sel[0], sel[2], sel[5], sel[6], sel[7],
                rot_p, hc_p, lc_p, hi_cloud_p, hi_valid, lo_cloud_p,
                lo_valid, atom_valid, ca_mask, np.int32(n_pairs),
                np.int32(n_samples), mu, M, x0p)
        with stage("refine"):
            res_r = refine_candidates(
                dmap, None, cfg.refine, mesh=mesh, device_starts=starts_r,
                n_atoms=n_atoms, frozen0=frozen0_r,
                extra=(sel, (res.rot, res.trans, res.coords, res.steps,
                             res.failed), post_d, sel_r_d))
        sel_h, main_h, post_h, sel_r_h = res_r.extra
        (order, assign, found_i, weights, gate, cand_order, n_cands,
         rep_full) = sel_h
    else:
        (order, assign, found_i, weights, gate, cand_order, n_cands,
         rep_full) = res.extra
    sanitize.check_host("match.repeat", np.asarray(rep_full)[:n_pairs])
    n_cands = int(n_cands)
    cap_needed = n_cands

    o = np.asarray(order[:n_pairs])
    table = MatchTable(
        cc=ccs[o], repeat=np.asarray(rep_full)[o], hi_idx=rows[o],
        lo_idx=cols[o], rot=rot[o], hi_coord=hi_coord[o],
        lo_coord=lo_coord[o], hi_cloud=hi_cloud, lo_cloud=lo_cloud)
    if match_cache and cached_table is None:
        _cache.save_matching(table, match_cache)
    hi_bins = sub_set.main_bin[table.hi_idx]
    lo_bins = map_set.main_bin[table.lo_idx]

    solutions: List[Solution] = []
    rcap_needed = 0

    def host_rescue_rounds(rounds: int) -> None:
        """Rescue rounds through the separate select+refine programs (the
        pre-post-fuse path): round 2+ of the fused flow, and every round
        of the overflow fallback. Same semantics as the split path."""
        nonlocal rcap_needed
        best_repeat = float(table.repeat[0]) if table.n else 0.0
        for _ in range(max(0, rounds)):
            if not solutions:
                break
            atoms = np.concatenate([s.structure.coords for s in solutions])
            d, _ = cKDTree(atoms).query(
                table.lo_coord, distance_upper_bound=mc.anchor_dist)
            elig = np.nonzero(d > mc.anchor_dist)[0]
            if not len(elig):
                break
            top = elig[:n_samples]
            pe_r = batch_bucket(max(len(top), 64), 64, mesh)
            n_scan_r = max(bucket(max(len(top), 64), 64), r_cap)
            rot_e = _pad_rows(table.rot[top].astype(np.float32), pe_r)
            rot_e[len(top):] = np.eye(3)
            hc_e = _pad_rows(table.hi_coord[top].astype(np.float32), pe_r)
            lc_e = _pad_rows(table.lo_coord[top].astype(np.float32), pe_r)
            with stage("rescue.rescore"):
                r_fn = _compiled_rescue_select(
                    a_hi, a_lo, pe_r, n_scan_r, r_cap, nb,
                    float(mc.anchor_dist), float(fc.rmsd_cloud),
                    int(fc.weight_threshold), float(fc.min_repeat),
                    float(fc.repeat_frac), mesh=mesh)
                sel_r, starts_r, frozen0_r = r_fn(
                    hi_cloud_p, hi_valid, lo_cloud_p, lo_valid, rot_e,
                    hc_e, lc_e, np.int32(len(top)),
                    np.float32(best_repeat), mu, M, x0p)
            with stage("refine"):
                res_l = refine_candidates(dmap, None, cfg.refine, mesh=mesh,
                                          device_starts=starts_r,
                                          n_atoms=n_atoms,
                                          frozen0=frozen0_r, extra=sel_r)
            (order_r, assign_r, found_r, weights_r, gate_r, cand_order_r,
             n_cands_r, erep_r) = res_l.extra
            n_cands_r = int(n_cands_r)
            rcap_needed = max(rcap_needed, n_cands_r)
            if n_cands_r == 0:
                break
            o_r = np.asarray(order_r)[: len(top)]
            sub_table = table.take(top[o_r],
                                   repeat=np.asarray(erep_r)[o_r])
            n_new = _merge_rescue_round(
                res_l, sub_table, map_set, sub_set, solutions, sub_struct,
                dmap, table, cfg, n_cands_r, r_cap,
                np.asarray(assign_r), np.asarray(found_r),
                np.asarray(weights_r), np.asarray(gate_r),
                np.asarray(cand_order_r))
            if verbose and n_new:
                print(f"MaD> Rescue round: {n_new} additional solution(s) "
                      "in unexplained density")
            if n_new == 0:
                break

    if n_cands > c_cap:
        # Frame overflow: every gated cluster, re-ranked on host, through
        # the split refine path (correct, one-off; the rung memory
        # right-sizes the next process). Any device post/rescue outputs
        # covered only the truncated lane set and are discarded.
        slots = np.nonzero(np.asarray(gate))[0]
        score = (table.repeat[np.asarray(found_i)[slots]]
                 * np.asarray(weights)[slots])
        slot_order = slots[np.argsort(-score, kind="stable")]
        candidates = _candidates_from_select(
            table, hi_bins, lo_bins, np.asarray(assign),
            np.asarray(found_i), np.asarray(weights), slot_order)
        if verbose:
            print(f"MaD> {len(candidates)} filtered pose candidates")
        if on_filtered is not None:
            on_filtered(candidates)
        if candidates:
            _refine_and_merge(candidates, solutions, sub_struct, dmap,
                              table, cfg)
        host_rescue_rounds(int(fc.rescue_rounds))
    else:
        slot_order = np.asarray(cand_order)[:n_cands]
        candidates = _candidates_from_select(
            table, hi_bins, lo_bins, np.asarray(assign),
            np.asarray(found_i), np.asarray(weights), slot_order)
        if verbose:
            print(f"MaD> {len(candidates)} filtered pose candidates")
        if on_filtered is not None:
            on_filtered(candidates)
        if not use_post:
            if candidates:
                res_slice = type(res)(
                    rot=res.rot[:n_cands], trans=res.trans[:n_cands],
                    coords=res.coords[:n_cands],
                    converged=res.converged[:n_cands],
                    steps=res.steps[:n_cands], failed=res.failed[:n_cands])
                _merge_refined(res_slice, candidates, solutions, sub_struct,
                               dmap, table, cfg)
            host_rescue_rounds(int(fc.rescue_rounds))
        else:
            # Rebuild the main round's Solution records from the device
            # post outputs (same data the host merge would have produced:
            # accepted lanes found solutions in candidate order, merged
            # lanes add their weight/members to their dedup target).
            (hits_h, counts_h, accepted_h, merge_to_h, _n_acc, top_rows_h,
             n_top_h) = post_h
            counts_h = np.asarray(counts_h)
            accepted_h = np.asarray(accepted_h)
            merge_to_h = np.asarray(merge_to_h)
            hits_h = np.asarray(hits_h)
            rot_m = np.asarray(main_h[0])
            trans_m = np.asarray(main_h[1])
            coords_m = np.asarray(main_h[2])
            n_hi = hi_cloud.shape[0]
            x032 = sub_struct.coords.astype(np.float32).astype(np.float64)
            sol_of_lane = {}
            for k, cand in enumerate(candidates):
                if not accepted_h[k]:
                    continue
                A = cand.rot.T.astype(np.float64)
                b = cand.lo_coord - cand.hi_coord.astype(np.float64) @ A
                center = (x032 @ A + b).mean(axis=0)
                s_a = (((table.hi_cloud @ A + b) - center)
                       @ rot_m[k].astype(np.float64)
                       + center + trans_m[k].astype(np.float64))
                struct = sub_struct.with_coords(
                    coords_m[k, :n_atoms].astype(np.float64))
                solutions.append(Solution(
                    structure=struct,
                    corresp_anchors=s_a[hits_h[k, :n_hi]],
                    repeat=100.0 * int(counts_h[k]) / n_hi,
                    weight=cand.weight, ccc=0.0,
                    members=list(cand.members)))
                sol_of_lane[k] = len(solutions) - 1
            for k, cand in enumerate(candidates):
                mt = int(merge_to_h[k])
                if mt >= 0:
                    j = sol_of_lane[mt]
                    solutions[j].weight += cand.weight
                    solutions[j].members.extend(cand.members)

            # Rescue round 1 from the chained device outputs.
            n_top = int(n_top_h)
            n_new = 0
            if solutions and n_top > 0:
                (order_r, assign_r, found_r, weights_r, gate_r,
                 cand_order_r, n_cands_r, erep_r) = sel_r_h
                n_cands_r = int(n_cands_r)
                rcap_needed = max(rcap_needed, n_cands_r)
                if n_cands_r > 0:
                    top = np.asarray(top_rows_h)[:n_top]
                    o_r = np.asarray(order_r)[:n_top]
                    sub_table = table.take(
                        top[o_r], repeat=np.asarray(erep_r)[o_r])
                    n_new = _merge_rescue_round(
                        res_r, sub_table, map_set, sub_set, solutions,
                        sub_struct, dmap, table, cfg, n_cands_r, r_cap,
                        np.asarray(assign_r), np.asarray(found_r),
                        np.asarray(weights_r), np.asarray(gate_r),
                        np.asarray(cand_order_r))
                    if verbose and n_new:
                        print(f"MaD> Rescue round: {n_new} additional "
                              "solution(s) in unexplained density")
            if n_new > 0 and int(fc.rescue_rounds) >= 2:
                host_rescue_rounds(int(fc.rescue_rounds) - 1)

    # Remember the right-sized candidate frames for future processes (not
    # adopted mid-process: a new frame would mean a cold compile mid-run).
    desired = int(min(max(16, -(-int(cap_needed * 1.25 + 4) // 16) * 16),
                      n_scan))
    if desired != c_cap:
        _frames_put(cap_key, (desired,))
    if rcap_needed:
        r_desired = int(min(max(8, -(-int(rcap_needed * 1.5 + 2) // 8) * 8),
                            n_scan))
        if r_desired != r_cap:
            _frames_put(rcap_key, (r_desired,))

    return _finalize_solutions(solutions, sub_struct, dmap, resolution, cfg)


def _finalize_solutions(solutions: List[Solution], sub_struct: Structure,
                        dmap: DensityGrid, resolution: float,
                        cfg: MadConfig) -> List[Solution]:
    """CC-score, RWmCC-rank (shared tail of both docking paths)."""
    if solutions:
        with stage("solution_ccc"):
            coords_b = np.stack([s.structure.coords for s in solutions])
            cccs = ccc_structures(dmap, coords_b, sub_struct.masses,
                                  resolution, shape_bucket=cfg.shape_bucket)
        for s, c in zip(solutions, cccs):
            s.ccc = float(c)
    for s in solutions:
        s.score = s.repeat * s.weight * s.ccc
    solutions.sort(key=lambda s: s.score, reverse=True)
    return solutions


def dock_structure(map_set: DescriptorSet, sub_set: DescriptorSet,
                   sub_struct: Structure, dmap: DensityGrid,
                   resolution: float, cfg: MadConfig, n_copies: int = 1,
                   verbose: bool = True, match_cache: str = None,
                   on_filtered=None, mesh=None, frame_group: str = ""
                   ) -> List[Solution]:
    """Dock one subunit into the map; returns scored unique solutions.

    match_cache: optional h5 path; when set, the match table is loaded from
    (or saved to) it — a working version of the reference's commented-out
    matching cache (mad/MaD.py:386-399).
    on_filtered: optional callback receiving the filtered pre-refinement
    Candidate list (the reference's pre_solutions hook, mad/MaD.py:404-405,
    891-921).
    mesh: optional jax.sharding.Mesh; matching shards the similarity rows
    and pair axes, refinement shards the candidate axis (same kernels as
    the single-device path, results equal up to similarity ties). The
    default fused path serves meshes too (shard_map variants of the same
    fused programs, engine/dock_fused).
    """
    import os as _os
    from .. import cache as _cache

    if _os.environ.get("MAD_TPU_FUSED_DOCK", "1") != "0":
        # Default path (single-device or mesh, match_cache included): the
        # post-similarity chain fuses into one dispatch per round and the
        # refinement chains on device. The split path below remains only
        # behind MAD_TPU_FUSED_DOCK=0.
        return _dock_structure_fused(map_set, sub_set, sub_struct, dmap,
                                     resolution, cfg, n_copies, verbose,
                                     on_filtered, mesh=mesh,
                                     match_cache=match_cache,
                                     frame_group=frame_group)

    n_samples = cfg.filter.n_samples * n_copies

    if match_cache and _os.path.exists(match_cache):
        table = _cache.load_matching(match_cache)
        if verbose:
            print(f"MaD> Loaded matched descriptor pairs from {match_cache}")
    else:
        with stage("match"):
            # Clustering consumes the top n_samples pairs by repeatability;
            # their ordering must be exact, not approximate (min_exact).
            table = match_descriptors(
                map_set, sub_set, dmap.shape, dmap.origin, dmap.voxsp,
                cfg.match, min_exact=n_samples, mesh=mesh)
        if match_cache:
            _cache.save_matching(table, match_cache)
    if verbose:
        print(f"MaD> {table.n} descriptor pairs above "
              f"cc={cfg.match.cc_threshold:.2f}")
    if table.n == 0:
        return []

    hi_bins = sub_set.main_bin[table.hi_idx]
    lo_bins = map_set.main_bin[table.lo_idx]
    with stage("cluster"):
        candidates = filter_pairs(table, hi_bins, lo_bins, cfg.filter,
                                  n_samples)
    if verbose:
        print(f"MaD> {len(candidates)} filtered pose candidates")
    if not candidates:
        return []
    if on_filtered is not None:
        on_filtered(candidates)

    solutions: List[Solution] = []
    _refine_and_merge(candidates, solutions, sub_struct, dmap, table, cfg,
                      mesh=mesh)

    # Rescue rounds: pairs whose map anchor no accepted solution explains
    # get a fresh n_samples budget under the same gates (the repeat gate
    # stays relative to the FULL table's best, so rescued poses clear the
    # same bar). Stops as soon as a round adds nothing.
    best_repeat = float(table.repeat[0]) if table.n else 0.0
    for _ in range(max(0, int(cfg.filter.rescue_rounds))):
        if not solutions:
            break
        atoms = np.concatenate([s.structure.coords for s in solutions])
        d, _ = cKDTree(atoms).query(
            table.lo_coord, distance_upper_bound=cfg.match.anchor_dist)
        elig = np.nonzero(d > cfg.match.anchor_dist)[0]
        if not len(elig):
            break
        top = elig[:n_samples]
        # Below the first-round prefix repeatabilities are approximate;
        # re-score exactly what this round consumes, then re-rank.
        with stage("rescue.rescore"):
            erep = exact_rescore(table, top, cfg.match.anchor_dist, mesh)
        order = np.argsort(-erep, kind="stable")
        sub_table = table.take(top[order], repeat=erep[order])
        with stage("rescue.cluster"):
            cands = filter_pairs(
                sub_table, sub_set.main_bin[sub_table.hi_idx],
                map_set.main_bin[sub_table.lo_idx], cfg.filter, n_samples,
                best_repeat=best_repeat)
        if not cands:
            break
        n_new = _refine_and_merge(cands, solutions, sub_struct, dmap,
                                  table, cfg, mesh=mesh)
        if verbose and n_new:
            print(f"MaD> Rescue round: {n_new} additional solution(s) in "
                  "unexplained density")
        if n_new == 0:
            break

    # CC-score the unique poses in one batched simulate + CCC program (CCC
    # values are order-independent, so scoring after the merge matches the
    # reference's interleaved computation, mad/MaD.py:598-618).
    return _finalize_solutions(solutions, sub_struct, dmap, resolution, cfg)
