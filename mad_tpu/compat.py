"""Record-style views over the struct-of-arrays descriptor tables.

The reference models every anchor as a mutable ``DensityFeature`` object
(mad/DensityFeature.py:5-143); this pipeline keeps struct-of-arrays
(engine/pipeline.DescriptorSet) for batched kernels. This module offers the
familiar per-anchor record view for users migrating from the reference,
including the ASCII occupancy rendering and per-record debug dumps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .core.eqsp import get_eqsp
from .core.eqsp_viz import occupancy_ascii
from .engine.pipeline import DescriptorSet


@dataclass
class AnchorRecord:
    """Read-only per-anchor record (mirrors DensityFeature's public fields:
    detector info mad/DensityFeature.py:35-41, orientation state :43-52,
    descriptor vector)."""

    index: int
    oct_scale: int
    coords: np.ndarray
    map_coords: np.ndarray
    subv_map_coords: np.ndarray
    main_bin: int
    sec_bin: int
    rfinal: np.ndarray
    eqsp_size: int
    subeqsp_size: int
    lin_ar_subeqsp: np.ndarray

    def show(self) -> str:
        s = ["#############################",
             "DF @o=%d: idx=%d main_bin=%d sec_bin=%d:"
             % (self.oct_scale, self.index, self.main_bin, self.sec_bin),
             "Base: %d" % self.eqsp_size,
             "> Coords: %.3f %.3f %.3f" % tuple(self.coords),
             "> Map coords: %.3f %.3f %.3f" % tuple(self.map_coords),
             "> Subv coords:%.3f %.3f %.3f" % tuple(self.subv_map_coords),
             "#############################"]
        text = "\n".join(s)
        print(text)
        return text

    def show_suboccupancy(self) -> str:
        """ASCII per-subregion zone histogram (the descriptor reshaped)."""
        eqsp = get_eqsp(self.subeqsp_size)
        v = self.lin_ar_subeqsp.reshape(-1, self.subeqsp_size)
        out = []
        for r, row in enumerate(v):
            out.append("region %02d:\n%s" % (r, occupancy_ascii(row, eqsp)))
        text = "\n".join(out)
        print(text)
        return text


_ANCHOR_DTYPE = np.dtype([
    ("index", "i4"), ("octave", "i4"), ("coords", "f8", 3),
    ("map_coords", "f8", 3), ("subv_map_coords", "f8", 3),
    ("main_bin", "i4"), ("sec_bin", "i4")])


def write_anchors(ds: DescriptorSet, outname: str,
                  save_regular: bool = False) -> None:
    """Dump a descriptor set's anchors as ``<outname>_data.npy`` (structured
    array, one record per anchor) plus ``<outname>.pdb`` dummy atoms for
    visualization — the reference's Detector I/O surface
    (mad/Detector.py:47-49, write_df_to_file :135-136, write_df_to_pdb
    :145-189; save_regular adds the on-lattice coordinates as chain B)."""
    rec = np.zeros(ds.n, dtype=_ANCHOR_DTYPE)
    rec["index"] = ds.anchor_id
    rec["octave"] = ds.octave
    rec["coords"] = ds.coords
    rec["map_coords"] = ds.map_coords
    rec["subv_map_coords"] = ds.subv_coords
    rec["main_bin"] = ds.main_bin
    rec["sec_bin"] = ds.sec_bin
    np.save(outname + "_data.npy", rec)
    coords = ds.subv_coords
    res = ["SUB"] * ds.n
    chain = ["A"] * ds.n
    if save_regular:
        coords = np.concatenate([coords, ds.map_coords])
        res += ["ORI"] * ds.n
        chain += ["B"] * ds.n
    from .core.structure import _atom_line
    with open(outname + ".pdb", "w") as fh:
        for i, xyz in enumerate(np.asarray(coords)):
            fh.write(_atom_line("ATOM", i + 1, "O", res[i], chain[i],
                                i + 1, xyz, "O", occ=1.0, bfac=0.0) + "\n")


def load_anchors(path: str) -> np.ndarray:
    """Load a ``write_anchors`` dump (parity mad/Detector.py:139-142)."""
    rec = np.load(path, allow_pickle=False)
    print("Det> Loaded %i anchors." % len(rec))
    return rec


def to_records(ds: DescriptorSet) -> List[AnchorRecord]:
    """Expand a DescriptorSet into per-anchor records."""
    desc = np.asarray(ds.desc)      # one pull if device-resident
    return [
        AnchorRecord(
            index=int(ds.anchor_id[i]), oct_scale=int(ds.octave[i]),
            coords=ds.coords[i], map_coords=ds.map_coords[i],
            subv_map_coords=ds.subv_coords[i], main_bin=int(ds.main_bin[i]),
            sec_bin=int(ds.sec_bin[i]), rfinal=ds.rfinal[i],
            eqsp_size=ds.eqsp_size, subeqsp_size=ds.subeqsp_size,
            lin_ar_subeqsp=desc[i])
        for i in range(ds.n)
    ]
