"""Combinatorial assembly building from per-subunit solutions.

Replaces MaD.build_assembly / _build_from_single / _build_models
(mad/MaD.py:192-223, 632-843):
  * per solution, a low-resolution occupancy grid (5 A / 2 A voxels /
    isovalue 0.2) simulated on device;
  * pairwise overlap fractions between all solutions;
  * homomultimers: all C(n_solutions, n_copies) combinations scored by
    [sum, std, max] pairwise overlap — the reference loops tuples in Python,
    here the overlap gathers are vectorized numpy over the combination index
    matrix;
  * heteromers: per-subunit subcomplexes, then the cartesian product across
    subunits;
  * models kept while max overlap <= threshold, CC-scored against the map at
    4 A, written as multi-chain PDBs with a complex_ranking.csv.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from itertools import combinations, product
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import AssemblyConfig
from ..core.grid import DensityGrid, ccc_grids, overlap_fraction
from ..core.structure import Structure
from ..ops.simulate import simulate_density
from ..utils.warmup import warmable


@dataclass
class AssemblyModel:
    components: List[int]          # global solution indices
    ccc: float
    sum_overlap: float
    std_overlap: float
    max_overlap: float


@dataclass
class DeferredOverlap:
    """Device-resident pairwise overlap matrix (``solution_overlap``
    defer=True): the enumeration head consumes it ON DEVICE without an
    intermediate host sync; host users pull it once, lazily, folded into
    the enumeration's own result pull where possible."""

    dev: object                    # (m_pad, m_pad) f32 upper-triangular
    n: int                         # real solution count
    _host: Optional[np.ndarray] = None

    def host(self) -> np.ndarray:
        if self._host is None:
            import jax
            self.set_host(jax.device_get(self.dev))
        return self._host

    def set_host(self, pulled) -> None:
        self._host = np.asarray(pulled)[: self.n, : self.n].astype(
            np.float64)


# Every enumeration restriction is announced (no silent coverage caps): the
# notes print as MaD> lines and accumulate here so the orchestrator can
# surface them in complex_ranking.csv metadata.
_enum_notes: List[str] = []


def _note(msg: str) -> None:
    print(msg)
    _enum_notes.append(msg)


def pop_enum_notes() -> List[str]:
    """Drain the enumeration-restriction notes recorded since the last call."""
    out = list(_enum_notes)
    _enum_notes.clear()
    return out


def _overlap_matrix(grids: Sequence[DensityGrid], cfg: AssemblyConfig,
                    isovalue: float = 1e-8) -> np.ndarray:
    """Pairwise overlap fractions (upper triangular, parity
    mad/MaD.py:663-668). Occupancy masks and nonzero counts are
    precomputed once instead of per pair."""
    from ..core.grid import overlap_boxes
    n = len(grids)
    # Crop each occupancy mask to its nonzero bounding box once; the
    # (bucketed) simulation boxes are mostly empty padding.
    masks, origins, counts = [], [], []
    for g in grids:
        m = g.host() >= isovalue
        nz = np.nonzero(m)
        if not len(nz[0]):
            masks.append(m[:1, :1, :1])
            origins.append(g.origin)
            counts.append(0)
            continue
        lo = np.array([a.min() for a in nz])
        hi = np.array([a.max() for a in nz]) + 1
        masks.append(m[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])
        origins.append(g.origin + lo * cfg.sim_voxsp)
        counts.append(int(masks[-1].sum()))
    ov = np.zeros((n, n))
    for i, j in combinations(range(n), 2):
        if counts[i] == 0:
            continue
        box = overlap_boxes(origins[i], masks[i].shape,
                            origins[j], masks[j].shape, cfg.sim_voxsp)
        if box is None:
            continue
        lo1, hi1, lo2, hi2 = box
        m1 = masks[i][lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]]
        m2 = masks[j][lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]]
        ov[i, j] = int(np.count_nonzero(m1 & m2)) / counts[i]
    return ov


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_pack_overlap(m: int, box: tuple, frame: tuple, zp: int):
    """One fused device program: occupancy grids -> bit-packed common-frame
    rows -> pairwise AND/popcount intersection counts -> overlap fractions.

    ``batched_simulate`` registers every box origin on the global voxel
    lattice (ops/simulate.py:159), so embedding each solution at its integer
    frame offset reproduces the per-pair origin arithmetic of the reference
    (structure_utils.py:163-259 via core.grid.overlap_boxes) exactly.
    Occupancy bits pack 32-per-uint32 along z; the pairwise intersection is
    popcount(a & b), so the full (m, X, Y, Z) frame never materializes and
    only the (m, m) fraction matrix leaves the device.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    X, Y = frame

    def run(dens, offsets):
        bitw = np.arange(32, dtype=np.uint32)   # numpy: no device constant

        def pack_one(args):
            d, off = args
            occ = (d > 0).astype(jnp.uint32)
            buf = jnp.zeros((X, Y, zp * 32), jnp.uint32)
            buf = lax.dynamic_update_slice(buf, occ,
                                           (off[0], off[1], off[2]))
            w = buf.reshape(X, Y, zp, 32) << bitw
            return jnp.sum(w, axis=-1, dtype=jnp.uint32).reshape(-1)

        packed = lax.map(pack_one, (dens, offsets))        # (m, X*Y*zp)

        def row(a):
            inter = lax.population_count(a[None] & packed)  # (m, L)
            return jnp.sum(inter.astype(jnp.int32), axis=1)

        counts = lax.map(row, packed)                       # (m, m) int32
        diag = jnp.diagonal(counts)
        ov = counts.astype(jnp.float32) / jnp.maximum(
            diag[:, None], 1).astype(jnp.float32)
        ov = jnp.where(diag[:, None] == 0, 0.0, ov)
        return jnp.triu(ov, k=1)

    return jax.jit(run)


def solution_overlap(structures: Sequence[Structure], cfg: AssemblyConfig,
                     defer: bool = False) -> np.ndarray:
    """Pairwise overlap-fraction matrix for a solution set, fully on device
    (parity mad/MaD.py:659-668): one batched simulate (atom counts padded
    with zero-mass atoms so hetero subunits share the program), one fused
    pack/popcount program, one (n, n) host pull. Replaces the
    solution_grids + _overlap_matrix host path, which pulled every
    occupancy grid to the host.

    defer=True skips the pull and returns a DeferredOverlap the enumeration
    heads chain onto device-side (one fewer host sync per assembly)."""
    import jax
    import jax.numpy as jnp
    from ..core.config import bucket
    from ..ops.simulate import batched_simulate

    n = len(structures)
    if n < 2:
        return np.zeros((n, n))
    n_max = max(s.n_atoms for s in structures)
    coords = np.stack([np.concatenate(
        [s.coords, np.repeat(s.coords[:1], n_max - s.n_atoms, axis=0)])
        for s in structures])
    masses = np.stack([np.concatenate(
        [s.masses, np.zeros(n_max - s.n_atoms, np.float32)])
        for s in structures])
    # Pad the solution count so the program caches across nearby run sizes
    # (padding rows are zero-mass -> zero occupancy -> zero overlap rows).
    m_pad = bucket(n, 8)
    if m_pad > n:
        coords = np.concatenate(
            [coords, np.repeat(coords[:1], m_pad - n, axis=0)])
        masses = np.concatenate(
            [masses, np.zeros((m_pad - n, n_max), np.float32)])
    dens, origins = batched_simulate(
        coords, masses, cfg.sim_resolution, cfg.sim_voxsp,
        isovalue=cfg.sim_isovalue)
    voxsp = cfg.sim_voxsp
    off = np.rint((origins - origins[:n].min(axis=0)) / voxsp).astype(
        np.int32)
    off = np.clip(off, 0, None)
    box = dens.shape[1:]
    ext = [bucket(int(box[a] + off[:n, a].max()), 32) for a in range(3)]
    fn = _compiled_pack_overlap(m_pad, tuple(box), (ext[0], ext[1]),
                                ext[2] // 32)
    ov = fn(dens, jnp.asarray(off))
    if defer:
        return DeferredOverlap(dev=ov, n=n)
    return np.asarray(jax.device_get(ov))[:n, :n].astype(np.float64)


def solution_grids(structures: Sequence[Structure], cfg: AssemblyConfig
                   ) -> List[DensityGrid]:
    """Low-res occupancy grids per solution (mad/MaD.py:659). Same-sized
    structures (the common case: copies of one subunit) simulate in one
    vmapped program."""
    from ..ops.simulate import batched_simulate
    import jax.numpy as jnp
    sizes = {s.n_atoms for s in structures}
    if len(sizes) == 1 and len(structures) > 1:
        coords = np.stack([s.coords for s in structures])
        masses = np.stack([s.masses for s in structures])
        dens, origins = batched_simulate(
            coords, masses, cfg.sim_resolution, cfg.sim_voxsp,
            isovalue=cfg.sim_isovalue)
        # Only occupancy is consumed downstream (overlap fractions);
        # pull compact int8 masks instead of the float grids.
        occ = np.asarray((dens > 0).astype(jnp.int8))
        return [DensityGrid(data=occ[i], origin=origins[i],
                            voxsp=cfg.sim_voxsp) for i in range(len(occ))]
    return [simulate_density(s, cfg.sim_resolution, cfg.sim_voxsp,
                             isovalue=cfg.sim_isovalue) for s in structures]


def _score_tuples(tuples: np.ndarray, overlap: np.ndarray,
                  chunk: int = 1 << 18):
    """[sum/n, std, max] of pairwise overlaps per tuple.

    Single-pass f32 statistics computed in row chunks — at C(23,10) scale
    the naive fancy-indexed f64 temporaries cost ~10 s on one host core.
    """
    m, n_copies = tuples.shape
    if n_copies == 1:
        z = np.zeros(m)
        return z, z, z
    pair_idx = list(combinations(range(n_copies), 2))
    i0 = np.asarray([p[0] for p in pair_idx])
    i1 = np.asarray([p[1] for p in pair_idx])
    npair = len(pair_idx)
    ov = np.ascontiguousarray(overlap, dtype=np.float32)
    # flat lookup: pair (a, b) -> overlap[a, b]
    nsol = ov.shape[0]
    flat = ov.reshape(-1)
    sums = np.empty(m, np.float64)
    stds = np.empty(m, np.float64)
    maxs = np.empty(m, np.float64)
    for c0 in range(0, m, chunk):
        t = tuples[c0:c0 + chunk]
        idx = t[:, i0].astype(np.int64) * nsol + t[:, i1]
        v = flat[idx]
        s = v.sum(axis=1, dtype=np.float64)
        ss = np.einsum("ij,ij->i", v, v, dtype=np.float64)
        sums[c0:c0 + chunk] = s
        var = np.maximum(ss / npair - (s / npair) ** 2, 0.0)
        stds[c0:c0 + chunk] = np.sqrt(var)
        maxs[c0:c0 + chunk] = v.max(axis=1)
    return sums / n_copies, stds, maxs


@functools.lru_cache(maxsize=512)
def _all_combinations(n: int, k: int) -> np.ndarray:
    """All C(n, k) index tuples as an (M, k) int array in lexicographic
    order, built by the memoized Pascal recurrence in vectorized numpy
    (itertools would materialize millions of Python tuples at this size)."""
    if k == 0:
        return np.zeros((1, 0), dtype=np.int32)
    if k == n:
        return np.arange(n, dtype=np.int32)[None, :]
    # combos(n, k) = [0 + (combos of {1..n-1} choose k-1)] U [combos w/o 0]
    sub = _all_combinations(n - 1, k - 1)
    with_first = np.concatenate(
        [np.zeros((len(sub), 1), np.int32), sub + 1], axis=1)
    without = _all_combinations(n - 1, k) + 1
    out = np.concatenate([with_first, without], axis=0)
    out.setflags(write=False)
    return out


def _unrank_combination(r: int, n: int, k: int) -> list:
    """r-th (0-based) k-combination of {0..n-1} in lexicographic order."""
    import math
    out = []
    x = 0
    for i in range(k):
        while math.comb(n - 1 - x, k - 1 - i) <= r:
            r -= math.comb(n - 1 - x, k - 1 - i)
            x += 1
        out.append(x)
        x += 1
    return out


_ENUM_NMAX = 64     # static solution-frame size for the unranking program


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_embed_sym(m_pad: int, frame: int):
    """(m_pad, m_pad) upper-triangular device overlap -> symmetrized
    (frame, frame) matrix with rows/cols >= ``t`` zeroed (the enumeration
    trim), chaining a DeferredOverlap into the head program with no host
    round trip."""
    import jax
    import jax.numpy as jnp

    k = min(m_pad, frame)
    ids = np.arange(k)

    def run(ov, t):
        sym = ov + ov.T
        mask = (ids < t).astype(jnp.float32)
        block = sym[:k, :k] * mask[:, None] * mask[None, :]
        return jnp.pad(block, ((0, frame - k), (0, frame - k)))

    return jax.jit(run)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_enumerate_head(k: int, head: int, chunk: int):
    """Head of the C(n, k) ranking by max pairwise overlap, ON DEVICE and
    shape-generic in n: combination ranks decode to occupancy masks via a
    scanned comb-number table (one scan step per candidate solution, no
    tuple matrices or trace-time constants), the per-tuple reduction is a
    masked outer-product max over the (padded, static) overlap matrix, and
    a running top-``head`` merges across rank chunks. n and C(n, k) enter
    only as runtime arguments, so one compile serves every solution count.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    nmax = _ENUM_NMAX
    # Numpy closure constants: eager jnp arrays embed device-resident
    # constants into the MLIR, and each costs a host pull at lower time —
    # see ops/orient.zone_ids_fn.
    slots = np.arange(k, dtype=np.int32)
    cols = np.arange(nmax, dtype=np.int32)

    def run(sym, tab, m):
        # sym: (nmax, nmax) f32 symmetric overlap (padded);
        # tab: (nmax, k) int32, tab[x, i] = C(n-1-x, k-1-i); m: int32 scalar
        def decode(r):
            # r: (chunk,) int32 ranks -> occupancy masks (chunk, nmax)
            def step(carry, xs):
                rem, slot, m2 = carry
                x, trow = xs
                c = jnp.sum(jnp.where(slot[:, None] == slots[None],
                                      trow[None], 0), axis=1)
                take = rem < c
                m2 = m2 + (cols == x)[None].astype(jnp.float32) \
                    * take[:, None]
                slot = slot + take.astype(jnp.int32)
                rem = rem - jnp.where(take, 0, c)
                return (rem, slot, m2), None

            init = (r, jnp.zeros_like(r),
                    np.zeros((r.shape[0], nmax), np.float32))
            (rem, slot, m2), _ = lax.scan(
                step, init, (cols, tab.astype(jnp.int32)))
            return m2

        n_chunks = (m + chunk - 1) // chunk

        def body(ci, state):
            best_neg, best_rank = state
            r = ci * chunk + np.arange(chunk, dtype=np.int32)
            valid = r < m
            m2 = decode(r)
            s = jnp.max(sym[None] * m2[:, :, None] * m2[:, None, :],
                        axis=(1, 2))
            s = jnp.where(valid, s, jnp.inf)
            neg = jnp.concatenate([best_neg, -s])
            rank = jnp.concatenate([best_rank, r])
            top, idx = lax.top_k(neg, head)
            return top, rank[idx]

        init = (np.full((head,), -np.inf, np.float32),
                np.zeros((head,), np.int32))
        best_neg, best_rank = lax.fori_loop(0, n_chunks, body, init)
        return best_rank, -best_neg

    return jax.jit(run)


def enumerate_homomultimer(n_solutions: int, n_copies: int,
                           overlap: np.ndarray,
                           max_combinations: int = 5_000_000,
                           head: int = 256):
    """Head of the candidate-tuple ranking for a homomultimer
    (mad/MaD.py:686-694: all C(n, k) tuples sorted by max pairwise overlap).

    Model building only consumes the head of that ranking (it stops at
    ``max_models`` or at the first clash, mad/MaD.py:730), so only the
    ``head`` best tuples are materialized: the max-overlap reduction over
    every tuple runs on device, the full host sort never happens. When
    C(n_solutions, n_copies) exceeds ``max_combinations`` the enumeration
    restricts to the best-ranked solutions (they arrive sorted by RWmCC)
    and says so (every restriction prints + records a note, pop_enum_notes).
    """
    import math
    import jax
    import jax.numpy as jnp
    from ..core.config import bucket
    deferred = overlap if isinstance(overlap, DeferredOverlap) else None
    n_orig = n_solutions
    n_copies = min(n_copies, n_solutions)
    while (n_solutions > n_copies
           and math.comb(n_solutions, n_copies) > max_combinations):
        n_solutions -= 1
    if n_solutions < n_orig:
        _note(f"MaD> enumeration restricted to the top {n_solutions} of "
              f"{n_orig} solutions (keeps C(n,{n_copies}) <= "
              f"{max_combinations:,} combinations)")
    if n_copies == 1:
        tuples = np.arange(n_solutions)[:, None]
        z = np.zeros(len(tuples))
        return tuples, z, z, z
    # Host path enumerates ALL C(n, k) tuples; solution counts above the
    # device unranking frame (_ENUM_NMAX) always take it, so no tuple is
    # ever dropped by the frame cap (at n > 64 the max_combinations trim
    # bounds k <= 4, cheap on host).
    if (math.comb(n_solutions, n_copies) <= 4 * head
            or n_solutions > _ENUM_NMAX):
        if deferred is not None:
            overlap = deferred.host()
        tuples = _all_combinations(n_solutions, n_copies)
        s, sd, mx = _score_tuples(tuples, overlap)
        order = np.argsort(mx, kind="stable")
        return tuples[order], s[order], sd[order], mx[order]

    _note(f"MaD> enumeration ranking computed on device; materializing the "
          f"best {head} of {math.comb(n_solutions, n_copies):,} tuples "
          "(model building consumes the ranking head only)")
    tab = np.zeros((_ENUM_NMAX, n_copies), np.int32)
    for x in range(n_solutions):
        for i in range(n_copies):
            tab[x, i] = math.comb(n_solutions - 1 - x, n_copies - 1 - i)
    if deferred is not None:
        # Chain the device overlap straight into the head program; the
        # matrix itself rides the head's result pull.
        m_pad = int(deferred.dev.shape[0])
        sym_d = _compiled_embed_sym(m_pad, _ENUM_NMAX)(
            deferred.dev, np.int32(n_solutions))
    else:
        sym = np.zeros((_ENUM_NMAX, _ENUM_NMAX), np.float32)
        ov_n = overlap[:n_solutions, :n_solutions]
        sym[:n_solutions, :n_solutions] = ov_n + ov_n.T
        sym_d = jnp.asarray(sym)
    fn = _compiled_enumerate_head(n_copies, head, chunk=1 << 14)
    idx, mx = fn(sym_d, jnp.asarray(tab),
                 np.int32(math.comb(n_solutions, n_copies)))
    if deferred is not None:
        keep, ov_pull = jax.device_get((idx, deferred.dev))
        deferred.set_host(ov_pull)
        overlap = deferred.host()
    else:
        keep = np.asarray(idx)
    top = np.asarray([_unrank_combination(int(r), n_solutions, n_copies)
                      for r in keep], dtype=np.int32)
    s, sd, mx2 = _score_tuples(top, overlap)
    order = np.argsort(mx2, kind="stable")
    return top[order], s[order], sd[order], mx2[order]


def _hetero_scores(gather: np.ndarray, overlap: np.ndarray):
    """[sum, std, max] per tuple of global indices; the reference computes
    them over the full meshgrid including the zero diagonal
    (mad/MaD.py:800-805)."""
    sym = overlap + overlap.T
    n = gather.shape[1]
    pair_idx = [(i, j) for i in range(n) for j in range(n)]
    a = gather[:, [p[0] for p in pair_idx]]
    b = gather[:, [p[1] for p in pair_idx]]
    vals = sym[a, b] * 0.5
    return vals.sum(axis=1), vals.std(axis=1), vals.max(axis=1)


@functools.lru_cache(maxsize=16)
@warmable
def _compiled_hetero_head(sizes: tuple, max_n: int, nsol: int, head: int,
                          chunk: int):
    """Head of the cartesian-product ranking ON DEVICE: tuple r decodes by
    mixed radix (no index matrices cross the host boundary), each tuple
    reduces to its summed pairwise overlap, chunked top-k keeps the
    smallest-sum head."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    g_count = len(sizes)
    m = 1
    for s in sizes:
        m *= s
    strides = []
    acc = 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))           # stride_g = prod(sizes[g+1:])
    pair_idx = list(combinations(range(g_count), 2))
    k_local = min(head, chunk)
    n_chunks = (m + chunk - 1) // chunk

    def run(sym, lists):
        def one_chunk(r0):
            # Numpy in-trace constants: see _compiled_enumerate_head.
            r = r0 + np.arange(chunk, dtype=np.int32)
            valid = r < m
            glob = jnp.stack(
                [lists[g, (r // strides[g]) % sizes[g]]
                 for g in range(g_count)], axis=1)             # (chunk, G)
            if pair_idx:
                i0 = np.asarray([p[0] for p in pair_idx])
                i1 = np.asarray([p[1] for p in pair_idx])
                s = jnp.sum(sym[glob[:, i0], glob[:, i1]], axis=1)
            else:
                s = jnp.zeros_like(r, dtype=jnp.float32)
            s = jnp.where(valid, s, jnp.inf)
            neg, i = lax.top_k(-s, k_local)
            return -neg, r[i]
        starts = np.arange(n_chunks, dtype=np.int32) * chunk
        sums, idxs = lax.map(one_chunk, starts)
        flat_s = sums.reshape(-1)
        flat_r = idxs.reshape(-1)
        neg, i = lax.top_k(-flat_s, min(head, flat_s.shape[0]))
        return flat_r[i], -neg

    return jax.jit(run)


def enumerate_heteromer(groups: Dict[str, List[int]], overlap: np.ndarray,
                        max_combinations: int = 50_000_000, head: int = 256):
    """Cartesian product of per-subunit candidate lists (mad/MaD.py:799-805).

    groups maps subunit key -> list of global solution indices (or of
    subcomplex indices). Tuples rank by summed pairwise overlap ascending
    (reference: sorted(key=itemgetter(1)), mad/MaD.py:809); model building
    only consumes the head of that ranking (mad/MaD.py:826-830), so beyond
    a small product size only the ``head`` best tuples are materialized:
    tuple indices decode and score on device, the full cartesian product
    never exists in host memory. When the product exceeds
    ``max_combinations`` the largest groups trim to their best-ranked
    entries (lists arrive ranking-sorted) and the trim is announced
    (printed + recorded, pop_enum_notes)."""
    deferred = overlap if isinstance(overlap, DeferredOverlap) else None
    lists = [np.asarray(v) for v in groups.values()]
    sizes = [len(v) for v in lists]
    sizes0 = list(sizes)
    while int(np.prod(sizes)) > max_combinations and max(sizes) > 1:
        g = int(np.argmax(sizes))
        sizes[g] -= 1
    if sizes != sizes0:
        trimmed = ", ".join(
            f"{k}: {a}->{b}" for k, a, b in zip(groups, sizes0, sizes)
            if a != b)
        _note(f"MaD> enumeration restricted to the best-ranked entries per "
              f"component ({trimmed}; keeps the cartesian product <= "
              f"{max_combinations:,} combinations)")
    lists = [lv[:s] for lv, s in zip(lists, sizes)]
    m = int(np.prod(sizes))

    if m <= 4 * head:
        if deferred is not None:
            overlap = deferred.host()
        tuples = np.array(list(product(*[range(s) for s in sizes])),
                          dtype=np.int64).reshape(m, len(sizes))
        gather = np.stack([lists[k][tuples[:, k]]
                           for k in range(len(lists))], axis=1)
        s, sd, mx = _hetero_scores(gather, overlap)
        order = np.argsort(s, kind="stable")
        return gather[order], s[order], sd[order], mx[order]

    import jax
    import jax.numpy as jnp
    _note(f"MaD> enumeration ranking computed on device; materializing the "
          f"best {head} of {m:,} tuples (model building consumes the "
          "ranking head only)")
    max_n = max(sizes)
    lists_p = np.zeros((len(sizes), max_n), dtype=np.int32)
    for g, lv in enumerate(lists):
        lists_p[g, : len(lv)] = lv
    if deferred is not None:
        # Symmetrize on device (frame = the padded device matrix; padding
        # rows are zero and never indexed by the group lists).
        m_pad = int(deferred.dev.shape[0])
        sym_d = _compiled_embed_sym(m_pad, m_pad)(deferred.dev,
                                                  np.int32(m_pad))
        nsol_key = m_pad
    else:
        sym_d = jnp.asarray((overlap + overlap.T).astype(np.float32))
        nsol_key = overlap.shape[0]
    fn = _compiled_hetero_head(tuple(sizes), max_n, nsol_key, head,
                               chunk=1 << 14)
    ridx, _sums = fn(sym_d, jnp.asarray(lists_p))
    if deferred is not None:
        ridx, ov_pull = jax.device_get((ridx, deferred.dev))
        deferred.set_host(ov_pull)
        overlap = deferred.host()
    ridx = np.asarray(ridx, dtype=np.int64)
    # decode head tuples on host (mixed radix), re-score for [sum, std, max]
    decoded = np.empty((len(ridx), len(sizes)), dtype=np.int64)
    rem = ridx.copy()
    for g in range(len(sizes) - 1, -1, -1):
        decoded[:, g] = rem % sizes[g]
        rem //= sizes[g]
    gather = np.stack([lists[k][decoded[:, k]]
                       for k in range(len(lists))], axis=1)
    s, sd, mx = _hetero_scores(gather, overlap)
    # stable (sum, cartesian-rank) order matches the reference's stable sort
    order = np.lexsort((ridx, s))
    return gather[order], s[order], sd[order], mx[order]


def score_models(tuples: np.ndarray, sums, stds, maxs,
                 structures: Sequence[Structure], dmap: DensityGrid,
                 cfg: AssemblyConfig, max_models: int, max_overlap: float
                 ) -> List[AssemblyModel]:
    """CC-score the accepted models (mad/MaD.py:726-745).

    All accepted model grids simulate and score in one vmapped program
    (padding hetero models to the largest atom count with zero-mass atoms).
    """
    accepted = []
    for cnt, tup in enumerate(tuples):
        if cnt >= max_models or (maxs[cnt] > max_overlap and cnt):
            break
        accepted.append(cnt)
    if not accepted:
        return []

    packs = []
    for cnt in accepted:
        coords = np.concatenate([structures[i].coords for i in tuples[cnt]])
        masses = np.concatenate([structures[i].masses for i in tuples[cnt]])
        packs.append((coords, masses))
    n_max = max(c.shape[0] for c, _ in packs)
    cb = np.zeros((len(packs), n_max, 3))
    mb = np.zeros((len(packs), n_max), dtype=np.float32)
    for i, (c, w) in enumerate(packs):
        cb[i, : len(c)] = c
        cb[i, len(c):] = c[0]      # zero-mass padding
        mb[i, : len(c)] = w
    from .score import ccc_structures
    cccs = ccc_structures(dmap, cb, mb, cfg.cc_resolution)

    out: List[AssemblyModel] = []
    for k, cnt in enumerate(accepted):
        out.append(AssemblyModel(
            components=[int(i) for i in tuples[cnt]], ccc=float(cccs[k]),
            sum_overlap=float(sums[cnt]), std_overlap=float(stds[cnt]),
            max_overlap=float(maxs[cnt])))
    return out
