"""Content-addressed descriptor cache (HDF5).

Parity with the reference's dsc_db/ store (mad/MaD.py:116-162, 848-875,
mad/Descriptor.py:226-254): same dataset names ('dsc', 'info', 'coords',
'rot') and the same parameter-string file naming, so cached runs short-cut
the describe pipeline identically. h5py is optional: without it the save
functions write nothing, so every lookup misses and the pipeline computes.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

from .engine.pipeline import DescriptorSet


def cache_filename(db_dir: str, name: str, resolution: float, isovalue: float,
                   detect_sigma: float, presmooth_sigma: float,
                   patch_size: int, ori_eqsp: int, dsc_eqsp: int,
                   subregions: int) -> str:
    """Reference-compatible cache key (mad/MaD.py:118)."""
    return os.path.join(
        db_dir,
        f"{name}_res{resolution}_iso{isovalue}_detSig{detect_sigma}"
        f"_presmooth{presmooth_sigma}_patch{patch_size}_orieqsp{ori_eqsp}"
        f"_dsceqsp{dsc_eqsp}_subregions{subregions}.h5")


def matching_filename(out_folder: str, key: str, cc_threshold: float,
                      weight_threshold: int, n_samples: int) -> str:
    """Reference-compatible matching-cache key (mad/MaD.py:387)."""
    return os.path.join(
        out_folder,
        f"matching_{key}_cc{cc_threshold:.2f}_w{weight_threshold}"
        f"_samples{n_samples}.h5")


def save_matching(table, path: str) -> None:
    """Persist a MatchTable (working version of the reference's
    commented-out matching cache, mad/MaD.py:386-399, 877-889)."""
    if h5py is None:
        return
    with h5py.File(path, "w") as hf:
        hf.create_dataset("cc", data=table.cc)
        hf.create_dataset("repeat", data=table.repeat)
        hf.create_dataset("hi_idx", data=table.hi_idx)
        hf.create_dataset("lo_idx", data=table.lo_idx)
        hf.create_dataset("rot", data=table.rot)
        hf.create_dataset("hi_coord", data=table.hi_coord)
        hf.create_dataset("lo_coord", data=table.lo_coord)
        hf.create_dataset("map_anchors", data=table.lo_cloud)
        hf.create_dataset("comp_anchors", data=table.hi_cloud)


def load_matching(path: str):
    from .engine.match import MatchTable
    with h5py.File(path, "r") as hf:
        return MatchTable(
            cc=np.asarray(hf["cc"]), repeat=np.asarray(hf["repeat"]),
            hi_idx=np.asarray(hf["hi_idx"]), lo_idx=np.asarray(hf["lo_idx"]),
            rot=np.asarray(hf["rot"]), hi_coord=np.asarray(hf["hi_coord"]),
            lo_coord=np.asarray(hf["lo_coord"]),
            hi_cloud=np.asarray(hf["comp_anchors"]),
            lo_cloud=np.asarray(hf["map_anchors"]))


def save_descriptors(ds: DescriptorSet, path: str) -> None:
    if h5py is None:
        return
    with h5py.File(path, "w") as hf:
        # ds.desc may carry 128-bucket zero padding rows (device frame);
        # the h5 schema stores the exact-count table (reference parity).
        hf.create_dataset("dsc",
                          data=np.asarray(ds.desc)[:ds.n].astype(np.int16))
        info = np.stack([
            ds.anchor_id, ds.main_bin, ds.sec_bin, ds.octave,
            np.full(ds.n, ds.eqsp_size), np.full(ds.n, ds.subeqsp_size),
        ], axis=1).astype(np.uint16)
        hf.create_dataset("info", data=info)
        coords = np.stack([ds.coords.astype(np.float64), ds.map_coords,
                           ds.subv_coords], axis=1)
        hf.create_dataset("coords", data=coords)
        hf.create_dataset("rot", data=ds.rfinal.astype(np.float64))


def load_descriptors(path: str, name: str = "") -> DescriptorSet:
    with h5py.File(path, "r") as hf:
        desc = np.asarray(hf["dsc"]).astype(np.int16)
        info = np.asarray(hf["info"])
        coords = np.asarray(hf["coords"])
        rot = np.asarray(hf["rot"]).astype(np.float32)
    norm = desc.astype(np.float32)
    lens = np.linalg.norm(norm, axis=1, keepdims=True)
    norm = np.where(lens > 0, norm / np.where(lens > 0, lens, 1.0), norm)
    n = desc.shape[0]
    return DescriptorSet(
        desc=desc, desc_norm=norm,
        coords=coords[:, 0].astype(np.float32),
        map_coords=coords[:, 1], subv_coords=coords[:, 2], rfinal=rot,
        octave=info[:, 3].astype(np.int32),
        anchor_id=info[:, 0].astype(np.int32),
        main_bin=info[:, 1].astype(np.int32),
        sec_bin=info[:, 2].astype(np.int32),
        eqsp_size=int(info[0, 4]) if n else 112,
        subeqsp_size=int(info[0, 5]) if n else 16,
        name=name or os.path.splitext(os.path.basename(path))[0])


# ---------------------------------------------------------------------------
# Pose-search checkpoint (SURVEY section 5, "failure detection" row:
# "optional checkpoint of pose search state"). The descriptor cache above
# resumes the describe stage; these resume the DOCK stage: a killed
# multi-subunit run reloads each completed subunit's solution set and
# continues at the first un-docked subunit (api.MaD._dock_one).
# ---------------------------------------------------------------------------

def solutions_filename(db_dir: str, map_name: str, key: str,
                       state_hash: str) -> str:
    return os.path.join(db_dir, f"solutions_{map_name}_{key}_"
                                f"{state_hash}.h5")


def dock_state_hash(struct_coords: np.ndarray, n_copies: int,
                    resolution: float, isovalue: float, cfg) -> str:
    """Content hash of everything the dock result depends on: the processed
    subunit coordinates (decoy transform included) and the dock-relevant
    config trees. A changed knob or input invalidates the checkpoint."""
    import hashlib
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(struct_coords, dtype=np.float64).tobytes())
    h.update(repr((n_copies, float(resolution), float(isovalue),
                   cfg.scalespace, cfg.detect, cfg.orient, cfg.describe,
                   cfg.match, cfg.filter, cfg.refine)).encode())
    return h.hexdigest()[:12]


def save_solutions(sols, path: str) -> None:
    """Persist a docked subunit's Solution list (engine/docking.Solution):
    refined coords, scores and the ragged corresp-anchor / member tables."""
    if h5py is None:
        return
    with h5py.File(path, "w") as hf:
        hf.attrs["n"] = len(sols)
        if not sols:
            return
        hf.create_dataset("coords", data=np.stack(
            [s.structure.coords for s in sols]))
        hf.create_dataset("scores", data=np.asarray(
            [[s.repeat, float(s.weight), s.ccc, s.score] for s in sols]))
        ca = [np.asarray(s.corresp_anchors, dtype=np.float64).reshape(-1, 3)
              for s in sols]
        hf.create_dataset("corresp", data=np.concatenate(ca)
                          if ca else np.zeros((0, 3)))
        hf.create_dataset("corresp_len",
                          data=np.asarray([len(a) for a in ca]))
        mem = [np.asarray(m, dtype=np.float64) for s in sols
               for m in s.members]
        hf.create_dataset("members", data=np.stack(mem)
                          if mem else np.zeros((0, 8)))
        hf.create_dataset("members_len",
                          data=np.asarray([len(s.members) for s in sols]))


def load_solutions(path: str, struct):
    """Rebuild the Solution list against ``struct`` (the processed
    subunit)."""
    from .engine.docking import Solution
    with h5py.File(path, "r") as hf:
        n = int(hf.attrs["n"])
        if n == 0:
            return []
        coords = np.asarray(hf["coords"])
        scores = np.asarray(hf["scores"])
        corresp = np.asarray(hf["corresp"])
        clen = np.asarray(hf["corresp_len"])
        members = np.asarray(hf["members"])
        mlen = np.asarray(hf["members_len"])
    sols = []
    co = mo = 0
    for i in range(n):
        sols.append(Solution(
            structure=struct.with_coords(coords[i]),
            corresp_anchors=corresp[co:co + clen[i]],
            repeat=float(scores[i, 0]), weight=int(scores[i, 1]),
            ccc=float(scores[i, 2]), score=float(scores[i, 3]),
            members=list(members[mo:mo + mlen[i]])))
        co += clen[i]
        mo += mlen[i]
    return sols
