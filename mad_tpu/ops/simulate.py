"""Structure -> simulated density map (device scatter + separable blur).

Replaces PDB.structure_to_density (mad/PDB.py:131-208) and
interpolate_to_grid_massweighted (mad/PDB.py:215-292):
  1. mass-weighted trilinear scatter of atoms onto a lattice-registered grid
     (margin = 2 + pad voxels), normalized to max 1;
  2. Gaussian blur with sigma = resolution / (pi*sqrt(2)) / voxsp truncated
     at ceil(3*sigma), *full* convolution (box grows by the kernel radius);
  3. normalize to max 1, clamp below the isovalue.

The reference loops over atoms in Python; here the scatter is one XLA
scatter-add over all 8 corner contributions and the 3D blur is three 1D
convolutions. Box dimensions and atom counts are bucketed so repeated calls
with similar structures reuse the compiled kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import bucket
from ..core.grid import DensityGrid
from ..core.structure import Structure
from .convolve import separable_conv3d
from ..utils.warmup import warmable


@dataclass(frozen=True)
class SimPlan:
    box: Tuple[int, int, int]       # scatter-grid dims (bucketed)
    vox_min: Tuple[float, float, float]  # lattice-registered min corner (A)
    margin: int
    radius: int                     # blur kernel radius (voxels)
    sigma: float                    # blur sigma (voxels)
    voxsp: float
    isovalue: float

    @property
    def out_origin(self) -> np.ndarray:
        return np.asarray(self.vox_min) - (self.radius + self.margin) * self.voxsp


def plan_simulation(coords: np.ndarray, resolution: float, voxsp: float,
                    isovalue: float = 0.0, pad: int = 0,
                    shape_bucket: int = 16) -> SimPlan:
    """Host-side planning: registered box extents + blur size."""
    mins = voxsp * np.floor(coords.min(axis=0) / voxsp)
    maxs = voxsp * np.ceil(coords.max(axis=0) / voxsp)
    margin = 2 + pad
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    dims = tuple(bucket(int(d), shape_bucket) for d in dims)
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    return SimPlan(box=dims, vox_min=tuple(float(m) for m in mins),
                   margin=margin, radius=radius, sigma=sigma, voxsp=voxsp,
                   isovalue=isovalue)


def simulated_shape(coords: np.ndarray, resolution: float, voxsp: float,
                    pad: int = 0, shape_bucket: int = 16
                    ) -> Tuple[int, int, int]:
    """Predict simulate_density's output grid shape without running it
    (host-only; used to prewarm the describe-side compile inventory)."""
    p = plan_simulation(np.asarray(coords), resolution, voxsp, pad=pad,
                        shape_bucket=shape_bucket)
    return tuple(b + 2 * p.radius for b in p.box)


@functools.lru_cache(maxsize=64)
@warmable
def _compiled_simulate(box: Tuple[int, int, int], margin: int, radius: int,
                       sigma: float, voxsp: float, isovalue: float):
    """Build + jit the scatter/blur kernel for one static box size."""
    r = radius
    x = np.arange(-r, r + 1, dtype=np.float64)
    k1 = np.exp(-(x * x) / (2.0 * sigma ** 2))
    k1 = (k1 / k1.sum()).astype(np.float32)

    def kernel(coords, masses, vox_min):
        # Voxel-space positions (margin offset, parity mad/PDB.py:263-267).
        g = margin + (coords - vox_min) / voxsp
        g0 = jnp.floor(g)
        frac = g - g0                                   # in [0, 1)
        i0 = g0.astype(jnp.int32)
        w1, w0 = frac, 1.0 - frac
        grid = jnp.zeros(box, dtype=jnp.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = (masses
                         * (w1[:, 0] if dx else w0[:, 0])
                         * (w1[:, 1] if dy else w0[:, 1])
                         * (w1[:, 2] if dz else w0[:, 2]))
                    grid = grid.at[i0[:, 0] + dx, i0[:, 1] + dy,
                                   i0[:, 2] + dz].add(w, mode="drop")
        grid = grid / jnp.maximum(jnp.max(grid), 1e-30)
        dens = separable_conv3d(grid, (k1, k1, k1), mode="full")
        dens = dens / jnp.maximum(jnp.max(dens), 1e-30)
        if isovalue:
            dens = jnp.where(dens < isovalue, 0.0, dens)
        return dens

    return jax.jit(kernel)


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_batched_simulate(m: int, n: int, box: Tuple[int, int, int],
                               margin: int, radius: int, sigma: float,
                               voxsp: float, isovalue: float):
    """Vmapped variant of the scatter/blur kernel: M structures with the
    same atom count and box size (e.g. docking solutions of one subunit)
    simulate in one program."""
    r = radius
    x = np.arange(-r, r + 1, dtype=np.float64)
    k1 = np.exp(-(x * x) / (2.0 * sigma ** 2))
    k1 = (k1 / k1.sum()).astype(np.float32)

    def one(coords, masses, vox_min):
        g = margin + (coords - vox_min) / voxsp
        g0 = jnp.floor(g)
        frac = g - g0
        i0 = g0.astype(jnp.int32)
        w1, w0 = frac, 1.0 - frac
        grid = jnp.zeros(box, dtype=jnp.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = (masses
                         * (w1[:, 0] if dx else w0[:, 0])
                         * (w1[:, 1] if dy else w0[:, 1])
                         * (w1[:, 2] if dz else w0[:, 2]))
                    grid = grid.at[i0[:, 0] + dx, i0[:, 1] + dy,
                                   i0[:, 2] + dz].add(w, mode="drop")
        grid = grid / jnp.maximum(jnp.max(grid), 1e-30)
        dens = separable_conv3d(grid, (k1, k1, k1), mode="full")
        dens = dens / jnp.maximum(jnp.max(dens), 1e-30)
        if isovalue:
            dens = jnp.where(dens < isovalue, 0.0, dens)
        return dens

    return jax.jit(jax.vmap(one))


def batched_simulate(coords: np.ndarray, masses: np.ndarray,
                     resolution: float, voxsp: float, isovalue: float = 0.0,
                     shape_bucket: int = 16):
    """Simulate M same-sized structures at once.

    coords: (M, N, 3); masses: (M, N). Each structure gets its own
    lattice-registered box; all share one (bucketed) box size.
    Returns (density (M, X, Y, Z) jnp, origins (M, 3) np).
    """
    m, n = coords.shape[:2]
    mins = voxsp * np.floor(coords.min(axis=1) / voxsp)          # (M, 3)
    maxs = voxsp * np.ceil(coords.max(axis=1) / voxsp)
    margin = 2
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    box = tuple(bucket(int(d), shape_bucket) for d in dims.max(axis=0))
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    n_pad = bucket(n, 256)
    c = np.zeros((m, n_pad, 3), dtype=np.float32)
    w = np.zeros((m, n_pad), dtype=np.float32)
    c[:, :n] = coords
    c[:, n:] = coords[:, :1]
    w[:, :n] = masses
    fn = _compiled_batched_simulate(m, n_pad, box, margin, radius, sigma,
                                    voxsp, isovalue)
    dens = fn(jnp.asarray(c), jnp.asarray(w),
              jnp.asarray(mins[:, None, :], dtype=jnp.float32))
    origins = mins - (radius + margin) * voxsp
    return dens, origins


def simulate_density(struct_or_coords, resolution: float, voxsp: float,
                     isovalue: float = 0.0, pad: int = 0,
                     masses: np.ndarray = None, shape_bucket: int = 16,
                     name: str = "") -> DensityGrid:
    """Simulate a density map from a structure at (resolution, voxsp)."""
    if isinstance(struct_or_coords, Structure):
        coords = struct_or_coords.coords
        masses = struct_or_coords.masses
        name = name or struct_or_coords.source
    else:
        coords = np.asarray(struct_or_coords)
        if masses is None:
            masses = np.full(coords.shape[0], 12.011, dtype=np.float32)
    plan = plan_simulation(coords, resolution, voxsp, isovalue, pad,
                           shape_bucket)
    n = coords.shape[0]
    n_pad = bucket(n, 256)
    c = np.zeros((n_pad, 3), dtype=np.float32)
    m = np.zeros((n_pad,), dtype=np.float32)
    c[:n] = coords
    c[n:] = coords[0]          # padded atoms alias atom 0 with zero mass
    m[:n] = masses
    fn = _compiled_simulate(plan.box, plan.margin, plan.radius, plan.sigma,
                            plan.voxsp, plan.isovalue)
    dens = fn(jnp.asarray(c), jnp.asarray(m),
              jnp.asarray(plan.vox_min, dtype=jnp.float32))
    # Stays device-resident; callers pull via DensityGrid.host() when needed.
    return DensityGrid(data=dens, origin=plan.out_origin,
                       voxsp=voxsp, name=name)
