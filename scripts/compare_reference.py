"""End-to-end parity comparison: reference MaD vs mad_tpu on one system.

Runs BOTH pipelines on the same synthetic self-fit problem and reports
solution agreement (CA-RMSD between the two implementations' best poses and
against ground truth). The reference needs skimage/mrcfile shims (absent in
this image); its code is untouched.

Usage: PYTHONPATH=/root/repo python scripts/compare_reference.py
(CPU-only; the reference is pure NumPy.)
"""

import os
import sys
import time
import types

# Force CPU before any jax import: the comparison with the NumPy reference
# runs on the host (the env var plus jax.config, before any jax use).
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np

REF = "/root/reference"


def install_shims():
    from scipy import ndimage

    def peak_local_max(grid, exclude_border=12, threshold_abs=0.05):
        mx = ndimage.maximum_filter(grid, size=3, mode="constant")
        mask = (grid >= mx) & (grid > threshold_abs)
        eb = exclude_border
        keep = np.zeros_like(mask)
        keep[eb:grid.shape[0] - eb, eb:grid.shape[1] - eb,
             eb:grid.shape[2] - eb] = True
        mask &= keep
        coords = np.argwhere(mask)
        order = np.argsort(-grid[tuple(coords.T)], kind="stable")
        return coords[order]

    sk = types.ModuleType("skimage")
    skf = types.ModuleType("skimage.feature")
    skf.peak_local_max = peak_local_max
    sk.feature = skf
    sys.modules.setdefault("skimage", sk)
    sys.modules.setdefault("skimage.feature", skf)
    sys.modules.setdefault("mrcfile", _make_mrcfile_shim())
    sys.path.insert(0, REF)


def _make_mrcfile_shim():
    """Functional mrcfile stand-in backed by mad_tpu.core.mrc_io — just the
    surface the reference touches (Dmap.py:27-43, 392-416, MapSpace.py:98):
    open().header fields / voxel_size.x / data, and new().set_data +
    header assignment inside a with-block."""
    from mad_tpu.core import mrc_io

    class _Vec:
        def __init__(self, x=0.0, y=0.0, z=0.0):
            self.x, self.y, self.z = x, y, z

    class _Header:
        def __init__(self):
            self.mx = self.my = self.mz = 0
            self.nxstart = self.nystart = self.nzstart = 0
            self.origin = _Vec()
            self.cella = _Vec()
            self.mapc, self.mapr, self.maps = 1, 2, 3

    class _Open:
        def __init__(self, path):
            hdr, data = mrc_io.read_mrc(path)
            self.data = data
            self.header = _Header()
            h = self.header
            h.mx, h.my, h.mz = hdr.mx, hdr.my, hdr.mz
            h.nxstart, h.nystart, h.nzstart = (hdr.nxstart, hdr.nystart,
                                               hdr.nzstart)
            h.origin = _Vec(*hdr.origin)
            h.cella = _Vec(*hdr.cella)
            h.mapc, h.mapr, h.maps = hdr.mapc, hdr.mapr, hdr.maps
            self.voxel_size = _Vec(hdr.cella[0] / max(hdr.mx, 1),
                                   hdr.cella[1] / max(hdr.my, 1),
                                   hdr.cella[2] / max(hdr.mz, 1))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _New:
        def __init__(self, path):
            self._path = path
            self.header = _Header()
            self.mode = 2
            self._data = None

        def set_data(self, arr):
            self._data = np.asarray(arr, dtype=np.float32)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if exc[0] is None and self._data is not None:
                h = self.header
                voxsp = (h.cella.x / max(h.mx, 1)) or 1.0
                mrc_io.write_mrc(self._path, self._data, voxsp,
                                 (h.origin.x, h.origin.y, h.origin.z))
            return False

    mod = types.ModuleType("mrcfile")
    mod.open = _Open
    mod.new = lambda path, overwrite=True: _New(path)
    return mod


def main():
    from mad_tpu.testing import make_assembly
    from mad_tpu.core.structure import write_pdb, parse_pdb
    from mad_tpu.core.grid import write_sit, read_map
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.engine.pipeline import describe_grid, describe_structure
    from mad_tpu.engine.docking import dock_structure
    from mad_tpu.core.config import MadConfig
    from mad_tpu import api as mad_api

    workdir = "/tmp/parity_run"
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)

    # Tiny self-fit dimer at 8 A / 2 A voxels.
    sub, copies = make_assembly(n_copies=2, n_res=50, seed=9, spread=15.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses)
    write_sit(dmap, "map.sit")
    moved = mad_api._decoy_transform(copies[0])
    write_pdb(moved, "subunit.pdb")

    # ---- mad_tpu
    cfg = MadConfig()
    t0 = time.time()
    map_set = describe_grid(dmap.reduce_void(), cfg, name="map")
    sub_set = describe_structure(moved, 8.0, 2.0, cfg, name="sub")
    sols = dock_structure(map_set, sub_set, moved, dmap.reduce_void(), 8.0,
                          cfg, n_copies=2, verbose=False)
    t_ours = time.time() - t0
    print(f"mad_tpu: {len(sols)} solutions in {t_ours:.1f}s "
          f"({map_set.n}/{sub_set.n} descriptors)")

    # ---- reference
    install_shims()
    cwd = os.getcwd()
    os.chdir(REF)
    from mad.MapSpace import MapSpace
    from mad.Detector import Detector
    from mad.Orientator import Orientator
    from mad.Descriptor import Descriptor
    from mad import MaD as refMaD
    from mad.Dmap import Dmap as RefDmap
    from mad.PDB import PDB as RefPDB
    os.chdir(cwd)

    t0 = time.time()

    def describe_ref(path, res, voxsp):
        os.chdir(REF)
        try:
            ms = MapSpace(path, resolution=res, voxelsp=voxsp,
                          map_padding=9, sig_init=2, sig_presmooth=1)
            det, ori, dsc = Detector(), Orientator(ori_radius=16), \
                Descriptor(dsc_radius=16)
            ori.step1_reject = 0
            ms.build_space()
            anchors = det.find_anchors(ms)
            oriented = ori.assign_orientations(ms, anchors)
            return dsc.generate_descriptors(ms, oriented), ms
        finally:
            os.chdir(cwd)

    # Prepare the reference's processed map like MaD._prep_files_folders
    ref_map = RefDmap(os.path.join(workdir, "map.sit"))
    ref_map.reduce_void()
    ref_map.write_to_sit(os.path.join(workdir, "map_reduced.sit"))

    map_dsc, _ = describe_ref(os.path.join(workdir, "map_reduced.sit"),
                              8.0, 2.0)
    sub_dsc, _ = describe_ref(os.path.join(workdir, "subunit.pdb"), 8.0, 2.0)
    print(f"reference: {len(map_dsc)}/{len(sub_dsc)} descriptors "
          f"in {time.time() - t0:.1f}s")

    mad = refMaD.MaD()
    mad.resolution = 8.0
    mad.voxsp = 2.0
    mad.processed_map = os.path.join(workdir, "map_reduced.sit")
    res = mad._match_dsc(map_dsc, sub_dsc, cc_threshold=0.6)
    match_results, lo_anchors, hi_anchors = res
    print(f"reference: {len(match_results)} pairs")
    filtered = mad._filter_dsc_pairs(
        os.path.join(workdir, "subunit.pdb"), match_results, lo_anchors,
        hi_anchors, wthresh=4, n_samples=120)
    print(f"reference: {len(filtered)} filtered candidates")
    refined = mad._refine_filtered_solutions(
        os.path.join(workdir, "subunit.pdb"), filtered, lo_anchors,
        hi_anchors)
    t_ref = time.time() - t0
    print(f"reference: {len(refined)} solutions in {t_ref:.1f}s total")

    # ---- compare
    print("\n=== parity report ===")
    print(f"speed: reference {t_ref:.1f}s vs mad_tpu {t_ours:.1f}s "
          f"(x{t_ref / max(t_ours, 1e-9):.1f})")
    for name, truth in (("copyA", copies[0]), ("copyB", copies[1])):
        best_t = min((s.structure.rmsd_ca_with(truth) for s in sols),
                     default=np.inf)
        best_r = np.inf
        for sol in refined:
            ref_pdb = sol[0]
            d = np.square(ref_pdb.coords[list(ref_pdb.CA_idx)]
                          - truth.coords[truth.ca_idx])
            best_r = min(best_r, float(np.sqrt(d.sum() / d.shape[0])))
        print(f"{name}: best CA-RMSD vs truth  reference={best_r:.2f} A  "
              f"mad_tpu={best_t:.2f} A")
    # direct cross-implementation agreement
    for i, s in enumerate(sols[:3]):
        ds = []
        for sol in refined:
            ref_pdb = sol[0]
            d = np.square(ref_pdb.coords - s.structure.coords)
            ds.append(float(np.sqrt(d.sum() / d.shape[0])))
        if ds:
            print(f"mad_tpu sol {i}: nearest reference solution "
                  f"RMSD={min(ds):.2f} A")


if __name__ == "__main__":
    main()
