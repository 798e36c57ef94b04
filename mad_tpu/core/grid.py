"""Density grid container + map I/O + grid-space scoring.

Replaces the reference's ``mad/Dmap.py`` (container/IO :6-97, CCC :153-372)
with a light dataclass. Grid data is float32 and may live on device (jnp) or
host (numpy); preprocessing ops run as jnp so a grid uploads once and stays
device-resident through the whole pipeline (no host<->device transfer per
stage). Origin arithmetic for overlapping-box
scores stays exact integer work on host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

from .mrc_io import read_mrc as _read_mrc_file
from .mrc_io import write_mrc as _write_mrc_file


def _warm_deco(factory):
    """lru_cache + warmable, imported lazily (grid loads before jax in
    some host-only tools)."""
    import functools
    from ..utils.warmup import warmable
    return functools.lru_cache(maxsize=8)(warmable(factory))


@_warm_deco
def _compiled_axis_any(shape):
    """Per-axis occupancy masks in ONE program / one host pull."""
    import jax
    import jax.numpy as jnp

    def run(d):
        occ = d != 0
        return (jnp.any(occ, (1, 2)), jnp.any(occ, (0, 2)),
                jnp.any(occ, (0, 1)))

    return jax.jit(run)


@_warm_deco
def _compiled_crop_pad(in_shape, out_shape, pad):
    """Dynamic-offset crop to a static shape + zero re-pad, fused."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    crop = tuple(s - 2 * pad for s in out_shape)

    def run(d, lo):
        c = lax.dynamic_slice(d, (lo[0], lo[1], lo[2]), crop)
        return jnp.pad(c, pad, mode="constant")

    return jax.jit(run)


@dataclass
class DensityGrid:
    """data[x, y, z] float32 (numpy or device array), origin in Angstroms,
    cubic voxels."""

    data: "np.ndarray"
    origin: np.ndarray          # (3,) float64
    voxsp: float
    name: str = ""

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    def device(self):
        """Device-resident float32 view of the data (cached)."""
        import jax.numpy as jnp
        dev = self.__dict__.get("_device_data")
        if dev is None:
            dev = jnp.asarray(self.data, dtype=jnp.float32)
            self.__dict__["_device_data"] = dev
        return dev

    def host(self) -> np.ndarray:
        """Host numpy view of the data (cached)."""
        h = self.__dict__.get("_host_data")
        if h is None:
            h = np.asarray(self.data)
            self.__dict__["_host_data"] = h
        return h

    def copy(self) -> "DensityGrid":
        return replace(self, data=self.data.copy(), origin=self.origin.copy())

    # -- preprocessing (parity: mad/Dmap.py:50-97) ------------------------

    def clamp_isovalue(self, isovalue: float) -> "DensityGrid":
        import jax.numpy as jnp
        d = self.device()
        mx = float(jnp.max(d))
        if mx > isovalue:
            d = jnp.where(d < isovalue, 0.0, d)
        else:
            d = jnp.where(d < 0, 0.0, d)
        return replace(self, data=d)

    def normalized(self) -> "DensityGrid":
        import jax.numpy as jnp
        d = self.device()
        m = float(jnp.max(d))
        if np.isclose(m, 0):
            return self
        return replace(self, data=d / m)

    def padded(self, pad: int) -> "DensityGrid":
        import jax.numpy as jnp
        return replace(
            self,
            data=jnp.pad(self.device(), pad, mode="constant"),
            origin=self.origin - pad * self.voxsp,
        )

    def reduce_void(self, zeros_padding: int = 10) -> "DensityGrid":
        """Crop to the nonzero bounding box then re-pad
        (parity: mad/Dmap.py:73-90). Host grids crop in numpy; device
        grids use two warmable programs (one consolidated mask pull + one
        fused dynamic crop/re-pad), so nothing here dispatches a one-off
        eager program."""
        if isinstance(self.data, np.ndarray):
            d = self.data
            occ = d != 0
            axes_any = [occ.any(axis=ax) for ax in ((1, 2), (0, 2), (0, 1))]
            if not axes_any[0].any():
                return self
            lo = np.array([int(np.argmax(a)) for a in axes_any])
            hi = np.array([len(a) - int(np.argmax(a[::-1]))
                           for a in axes_any])
            p = zeros_padding
            data = np.pad(d[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]], p,
                          mode="constant")
            return replace(self, data=data,
                           origin=self.origin + (lo - p) * self.voxsp)
        import jax
        d = self.device()
        axes_any = [np.asarray(a) for a in
                    jax.device_get(_compiled_axis_any(tuple(d.shape))(d))]
        if not axes_any[0].any():
            return self
        lo = np.array([int(np.argmax(a)) for a in axes_any])
        hi = np.array([len(a) - int(np.argmax(a[::-1])) for a in axes_any])
        p = zeros_padding
        out_shape = tuple(int(h - l) + 2 * p for l, h in zip(lo, hi))
        data = _compiled_crop_pad(tuple(d.shape), out_shape, p)(
            d, lo.astype(np.int32))
        return replace(self, data=data,
                       origin=self.origin + (lo - p) * self.voxsp)

    def mask_with(self, mask: "DensityGrid", eps: float = 1e-8
                  ) -> "DensityGrid":
        """Zero every voxel that is zero (or outside) in the mask grid
        (parity: Dmap.mask_with, mad/Dmap.py:99-151)."""
        if not np.isclose(self.voxsp, mask.voxsp):
            raise ValueError(
                f"voxel spacings do not match: {self.voxsp} vs {mask.voxsp}")
        out = np.zeros(self.shape, dtype=np.float32)
        box = self.overlap_box_with(mask)
        if box is not None:
            lo1, hi1, lo2, hi2 = box
            mdata = mask.host()
            sdata = self.host()
            common = mdata[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]]
            region = sdata[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]]
            out[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]] = np.where(
                common < eps, 0.0, region)
        return replace(self, data=out)

    # -- scoring ----------------------------------------------------------

    def overlap_box_with(self, other: "DensityGrid"):
        return overlap_boxes(
            self.origin, self.shape, other.origin, other.shape, self.voxsp
        )

    def ccc_with(self, other: "DensityGrid", isovalue: float = 0.0) -> float:
        """Normalized cross-correlation over the overlapping box
        (parity: Dmap.get_CCC_with_grid, mad/Dmap.py:153-258)."""
        return ccc_grids(
            self.host(), self.origin, other.host(), other.origin, self.voxsp,
            isovalue=isovalue,
        )


def overlap_boxes(origin1, shape1, origin2, shape2, voxsp):
    """Index ranges of the voxel-aligned intersection of two grids.

    Returns (lo1, hi1, lo2, hi2) int arrays or None when disjoint. Mirrors
    the origin arithmetic of mad/Dmap.py:170-234 (round-to-nearest voxel).
    """
    o1 = np.asarray(origin1, dtype=np.float64) / voxsp
    o2 = np.asarray(origin2, dtype=np.float64) / voxsp
    s1 = np.asarray(shape1, dtype=np.int64)
    s2 = np.asarray(shape2, dtype=np.int64)
    shift = np.rint(o2 - o1).astype(np.int64)   # grid2 origin in grid1 index space
    lo1 = np.maximum(shift, 0)
    hi1 = np.minimum(s1, s2 + shift)
    if np.any(hi1 <= lo1):
        return None
    lo2 = lo1 - shift
    hi2 = hi1 - shift
    return lo1, hi1, lo2, hi2


def ccc_grids(grid1, origin1, grid2, origin2, voxsp, isovalue: float = 0.0):
    """CCC = <g1, g2> / sqrt(<g1,g1><g2,g2>) over the overlap box.

    Parity with mad/Dmap.py:153-258, including that the norms are taken over
    the overlap box only (not the full grids).
    """
    grid1 = np.asarray(grid1)
    grid2 = np.asarray(grid2)
    box = overlap_boxes(origin1, grid1.shape, origin2, grid2.shape, voxsp)
    if box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    m1 = grid1[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]].astype(np.float64)
    m2 = grid2[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]].astype(np.float64)
    if isovalue:
        m1 = np.where(m1 < isovalue, 0.0, m1)
        m2 = np.where(m2 < isovalue, 0.0, m2)
    olap = float(np.vdot(m1, m2))
    n1 = float(np.vdot(m1, m1))
    n2 = float(np.vdot(m2, m2))
    denom = np.sqrt(n1 * n2)
    if denom == 0:
        return 0.0
    return olap / denom


def ccc_maps_scaled(m1: "DensityGrid", m2: "DensityGrid",
                    isovalue: float = 0.0) -> float:
    """Common-voxel-scaled CCC between two maps
    (parity: Dmap.get_CCC_with_dmap, mad/Dmap.py:260-372): each map is
    normalized over the voxels where the *other* map is nonzero, the dot
    product is then scaled by the fraction of the smaller map's nonzero
    voxels that are shared."""
    if m1.voxsp != m2.voxsp:
        raise ValueError(f"voxsp differ ({m1.voxsp} vs {m2.voxsp})")
    box = m1.overlap_box_with(m2)
    if box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    a = m1.data[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]].astype(
        np.float64).copy()
    b = m2.data[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]].astype(
        np.float64).copy()
    nonzero = min(np.count_nonzero(m1.data > isovalue),
                  np.count_nonzero(m2.data > isovalue))
    common = int(np.count_nonzero(b[(b > isovalue) & (a > isovalue)]))
    if not common or not nonzero:
        return 0.0
    na = np.linalg.norm(a[b > 0])
    nb = np.linalg.norm(b[a > 0])
    if na == 0 or nb == 0:
        return 0.0
    a /= na
    b /= nb
    return float(np.vdot(a, b)) * common / nonzero


def overlap_fraction(grid1, origin1, grid2, origin2, voxsp,
                     isovalue: float = 1e-8) -> float:
    """Fraction of grid1's nonzero voxels that overlap nonzero voxels of
    grid2 (parity: structure_utils.get_overlap, mad/structure_utils.py:163-259)."""
    g1 = np.where(np.asarray(grid1) < isovalue, 0.0, np.asarray(grid1))
    g2 = np.where(np.asarray(grid2) < isovalue, 0.0, np.asarray(grid2))
    box = overlap_boxes(origin1, g1.shape, origin2, g2.shape, voxsp)
    m1_vals = np.count_nonzero(g1 > 0)
    if m1_vals == 0 or box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    m1 = g1[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]]
    m2 = g2[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]]
    common = int(np.count_nonzero((m1 > 0) & (m2 > 0)))
    return common / m1_vals


# -- file I/O -------------------------------------------------------------

def read_map(path: str, isovalue: float = 0.0, normalize: bool = True
             ) -> DensityGrid:
    """Load .mrc/.map/.sit/.situs into a DensityGrid
    (parity: mad/Dmap.py:11-67 incl. MRC axis-order + nxstart/origin handling,
    with the reference's voxsp AttributeError at MapSpace.py:106 fixed)."""
    ext = os.path.splitext(path)[-1].lower()
    name = os.path.splitext(os.path.split(path)[-1])[0]
    if ext in (".sit", ".situs"):
        g = _read_sit(path, name)
    elif ext in (".map", ".mrc"):
        g = _read_mrc(path, name)
    else:
        raise ValueError(f"Unsupported map format: {path}")
    g = g.clamp_isovalue(isovalue)
    if normalize:
        g = g.normalized()
    return g


def _read_sit(path: str, name: str) -> DensityGrid:
    with open(path, "rb") as fh:
        header = fh.readline().decode().split()
        fh.readline()
        body = fh.read()
    try:
        from ..native import get_fastio
        native = get_fastio()
    except Exception:
        native = None
    if native is not None:
        grid1d = np.frombuffer(native.parse_floats(body), dtype=np.float64)
    else:
        grid1d = np.fromiter((float(t) for t in body.split()),
                             dtype=np.float64)
    voxsp, xi, yi, zi = [float(x) for x in header[:4]]
    xb, yb, zb = [int(x) for x in header[4:7]]
    data = np.reshape(grid1d.astype(np.float32), (xb, yb, zb), order="F")
    return DensityGrid(data=data, origin=np.array([xi, yi, zi]),
                       voxsp=voxsp, name=name)


def _read_mrc(path: str, name: str) -> DensityGrid:
    hdr, raw = _read_mrc_file(path)
    axis_order = [hdr.mapc - 1, hdr.mapr - 1, hdr.maps - 1]
    voxsp = hdr.voxel_size_x
    if all([hdr.nxstart, hdr.nystart, hdr.nzstart]):
        start = np.array([hdr.nxstart, hdr.nystart, hdr.nzstart])
        origin = np.array([start[a] * voxsp for a in axis_order],
                          dtype=np.float64)
    else:
        o = np.asarray(hdr.origin, dtype=np.float64)
        origin = np.array([o[a] for a in axis_order])
    data = np.transpose(raw, axis_order[::-1]).astype(np.float32)
    return DensityGrid(data=data, origin=origin, voxsp=voxsp, name=name)


def write_mrc(grid: DensityGrid, path: str) -> None:
    """Write MRC with mapc/r/s = 1/2/3 and origin header
    (parity: mad/Dmap.py:392-416)."""
    _write_mrc_file(path, grid.host().astype(np.float32).transpose(2, 1, 0),
                    grid.voxsp, grid.origin)


def write_sit(grid: DensityGrid, path: str) -> None:
    """Situs text format (parity: mad/Dmap.py:377-390)."""
    xb, yb, zb = grid.shape
    vals = grid.host().transpose(2, 1, 0).reshape(-1)  # x fastest
    with open(path, "w") as fh:
        fh.write("%f %f %f %f %i %i %i\n\n" % (
            grid.voxsp, grid.origin[0], grid.origin[1], grid.origin[2],
            xb, yb, zb))
        for i in range(0, len(vals), 10):
            fh.write("   " + "   ".join("%6.6f" % v for v in vals[i:i + 10])
                     + "   \n")
