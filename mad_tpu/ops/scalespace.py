"""Gaussian/LoG scale-space construction on device.

Replaces MapSpace.build_space (mad/MapSpace.py:69-189):
  * optional x2 upsampled octave (cubic, presmoothed),
  * per octave: scale-normalized negative LoG (clamped at 0), plus the
    gradient of the Gaussian-smoothed grid for orientation/descriptors.

Everything per shape is jitted once; grids are bucketed by the caller so a
run over many structures reuses a handful of compiled programs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import ScaleSpaceConfig, bucket
from ..core.grid import DensityGrid
from .convolve import gaussian_filter3d, log_filter3d, upsample2
from ..utils.warmup import warmable


@dataclass
class Octave:
    """One scale-space octave, device-resident."""

    voxsp: float
    log: jnp.ndarray          # (X, Y, Z) clamped -sigma^2 * LoG
    grad: jnp.ndarray         # (X, Y, Z, 3) gradient of Gaussian-smoothed grid
    real_shape: Tuple[int, int, int]  # data extent before bucket padding


@dataclass
class ScaleSpace:
    octaves: List[Octave]
    origin: np.ndarray        # shared map origin (A) after padding
    name: str = ""


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_build(shape: Tuple[int, int, int], sig_init: float,
                    sig_presmooth: float, oct_mode: str, truncate: float):
    def one_octave(vol):
        log_resp, gauss = log_filter3d(vol, sig_init, truncate)
        gx, gy, gz = jnp.gradient(gauss)
        return log_resp, jnp.stack([gx, gy, gz], axis=-1)

    def build(vol):
        outs = []
        if oct_mode in ("up", "both"):
            up = upsample2(vol)
            if sig_presmooth:
                up = gaussian_filter3d(up, sig_presmooth, truncate)
            outs.append(one_octave(up))
        if oct_mode in ("base", "both"):
            outs.append(one_octave(vol))
        return outs

    return jax.jit(build)


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_prepare_pad(in_shape: Tuple[int, int, int], pad: int,
                          dims: Tuple[int, int, int]):
    """Symmetric map padding + bucket padding fused into one warmable
    program (the two eager jnp.pad calls each compiled a one-off program
    per shape per process)."""

    def run(d):
        return jnp.pad(d, [(pad, pad + dims[a] - in_shape[a] - 2 * pad)
                           for a in range(3)], mode="constant")

    return jax.jit(run)


def _prepare(grid: DensityGrid, cfg: ScaleSpaceConfig, shape_bucket: int,
             mesh=None):
    data = grid.device()
    origin = grid.origin.copy()
    pad = int(cfg.map_padding)
    in_shape = tuple(data.shape)
    if pad and mesh is None:
        origin = origin - pad * grid.voxsp
        real = tuple(s + 2 * pad for s in in_shape)
        dims = tuple(bucket(s, shape_bucket) for s in real)
        data = _compiled_prepare_pad(in_shape, pad, dims)(data)
        return data, origin, real, dims
    if pad:
        data = jnp.pad(data, pad, mode="constant")
        origin = origin - pad * grid.voxsp
    real = tuple(data.shape)
    dims = tuple(bucket(s, shape_bucket) for s in real)
    if mesh is not None:
        # The explicit device_put below needs dim 0 divisible by the mesh
        # (GSPMD pads internally only for shardings introduced inside jit).
        from ..parallel.mesh import mesh_size
        n = mesh_size(mesh)
        d0 = dims[0]
        while d0 % n:
            d0 += shape_bucket
        dims = (d0,) + dims[1:]
    if dims != real:
        data = jnp.pad(data, [(0, d - r) for d, r in zip(dims, real)])
    if mesh is not None:
        # SP: shard the volume along dim 0; XLA's SPMD partitioner inserts
        # halo exchanges for the separable filters (parallel/volume.py
        # proves equality on a virtual mesh).
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import mesh_axis
        data = jax.device_put(
            data, NamedSharding(mesh, P(mesh_axis(mesh), None, None)))
    return data, origin, real, dims


def _mesh_out(mesh, ndim: int):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import mesh_axis
    return NamedSharding(
        mesh, P(mesh_axis(mesh), *([None] * (ndim - 1))))


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_log(shape: Tuple[int, int, int], sig_init: float,
                  sig_presmooth: float, up: bool, truncate: float,
                  mesh=None):
    """mesh (capacity mode): the output stays x-slab-sharded; the upsampled
    octave's odd dim 0 (2X-1) pads by one zero row so it divides the mesh
    (the real_shape bounds checks downstream ignore the pad row)."""
    def build(vol):
        if up:
            vol = upsample2(vol)
            if sig_presmooth:
                vol = gaussian_filter3d(vol, sig_presmooth, truncate)
        log_resp, _ = log_filter3d(vol, sig_init, truncate)
        if mesh is not None and up:
            log_resp = jnp.pad(log_resp, ((0, 1), (0, 0), (0, 0)))
        return log_resp

    if mesh is None:
        return jax.jit(build)
    return jax.jit(build, out_shardings=_mesh_out(mesh, 3))


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_log_detect(shape: Tuple[int, int, int], sig_init: float,
                         sig_presmooth: float, up: bool, truncate: float,
                         real_shape: Tuple[int, int, int], threshold: float,
                         exclude_border: int, max_offset: float, n_iter: int,
                         capacity: int, spec_k: int):
    """Fused LoG + anchor detection + valid-first anchor compaction: one
    dispatch, no LoG volume crossing a program boundary, no host sync for
    the anchor count (it returns as an async scalar; engine/pipeline.py
    streamed path)."""
    return jax.jit(_log_detect_body(
        shape, sig_init, sig_presmooth, up, truncate, real_shape, threshold,
        exclude_border, max_offset, n_iter, capacity, spec_k))


def _log_detect_body(shape, sig_init, sig_presmooth, up, truncate,
                     real_shape, threshold, exclude_border, max_offset,
                     n_iter, capacity, spec_k):
    """Unjitted LoG+detect+compaction body (shared with the whole-octave
    fused chain, engine/pipeline._compiled_octave_chain)."""
    from .detect import _detect_core

    log_shape = (tuple(2 * s - 1 for s in shape) if up else tuple(shape))
    det = _detect_core(log_shape, tuple(real_shape), float(threshold),
                       int(exclude_border), float(max_offset), int(n_iter),
                       int(capacity))

    def build(vol):
        if up:
            vol = upsample2(vol)
            if sig_presmooth:
                vol = gaussian_filter3d(vol, sig_presmooth, truncate)
        log_resp, _ = log_filter3d(vol, sig_init, truncate)
        pos, subvox, vals, valid = det(log_resp)
        n_anch = jnp.sum(valid)
        order_a = jnp.argsort(~valid, stable=True)[:spec_k].astype(jnp.int32)
        return pos[order_a], valid[order_a], order_a, subvox, n_anch

    return build


@functools.lru_cache(maxsize=32)
@warmable
def _compiled_grad(shape: Tuple[int, int, int], sig_init: float,
                   sig_presmooth: float, up: bool, truncate: float,
                   dtype: str = "float32", mesh=None, donate: bool = False):
    """Gradient-of-Gaussian field. dtype='bfloat16' halves memory on very
    large octaves (gradients only feed direction binning; bf16 directions
    shift a negligible fraction of zone assignments). mesh: as for
    _compiled_log — output stays sharded, odd upsampled dim 0 padded.
    donate: the input volume is donated to XLA (the FINAL octave's
    gradient is the last consumer of the shared padded volume, so its
    ~V*4 bytes are reusable for the build temporaries — the scale-space
    HBM peak, SURVEY §5 donation audit)."""
    build = _grad_body(shape, sig_init, sig_presmooth, up, truncate, dtype,
                       mesh)
    if mesh is None:
        return jax.jit(build, donate_argnums=(0,) if donate else ())
    return jax.jit(build, out_shardings=_mesh_out(mesh, 4))


def _grad_body(shape, sig_init, sig_presmooth, up, truncate,
               dtype="float32", mesh=None):
    """Unjitted gradient-field body (shared with the fused octave chain)."""
    out_dtype = jnp.dtype(dtype)

    def build(vol):
        if up:
            vol = upsample2(vol)
            if sig_presmooth:
                vol = gaussian_filter3d(vol, sig_presmooth, truncate)
        gauss = gaussian_filter3d(vol, sig_init, truncate)
        if out_dtype == jnp.float32:
            gx, gy, gz = jnp.gradient(gauss)
            out = jnp.stack([gx, gy, gz], axis=-1)
        else:
            comps = []
            for ax in range(3):
                g = jnp.gradient(gauss, axis=ax)
                comps.append(g.astype(out_dtype))  # cast early: smaller peak
            out = jnp.stack(comps, axis=-1)
        if mesh is not None and up:
            out = jnp.pad(out, ((0, 1), (0, 0), (0, 0), (0, 0)))
        return out

    return build


class LazyOctave:
    """Octave whose LoG and gradient volumes build on demand as separate
    programs: detection runs with only the LoG resident, orientation /
    descriptors with only the gradient — halving peak memory on big maps
    (the upsampled octave of a 350^3 map is ~690^3)."""

    def __init__(self, data, dims, voxsp, real_shape, up, cfg, mesh=None,
                 final=False):
        self._data = data
        self._args = (dims, float(cfg.detect_sigma),
                      float(cfg.presmooth_sigma), up, float(cfg.truncate))
        self._mesh = mesh
        self._final = final     # last octave sharing the padded volume:
                                # its gradient program donates the input
        self.voxsp = voxsp
        self.real_shape = real_shape

    # Above this many octave voxels the gradient field is stored as bf16.
    # Derivation: the fused octave chain, which holds the LoG, the f32
    # gradient field and the orientation/descriptor work at once, compiles
    # to 30.2 B per real octave voxel on an H100 (bench map octave 0,
    # memory_analysis). The streamed gradient program holds less, so 30 B
    # bounds it; JAX's default pool is 75 % of an 80 GB card, 60 GB, and
    # 60e9 / 30 = 2e9 voxels. In capacity mode (mesh) the PER-DEVICE
    # shard is what must fit, so the gate scales by the mesh size.
    BF16_VOXELS = 2_000_000_000

    def log(self):
        if self._mesh is None:      # kwarg omitted: manifest-key stability
            return _compiled_log(*self._args)(self._data)
        return _compiled_log(*self._args, mesh=self._mesh)(self._data)

    def log_detect(self, det_cfg, spec_k: int):
        """Fused LoG + detection + anchor compaction (single-device streamed
        path): returns (coords_c, valid_c, order_a, subvox_full, n_anch),
        all device-resident, no sync."""
        fn = _compiled_log_detect(
            *self._args, tuple(self.real_shape), float(det_cfg.threshold_abs),
            int(det_cfg.exclude_border), float(det_cfg.max_offset),
            int(det_cfg.newton_iters), int(det_cfg.max_anchors), int(spec_k))
        return fn(self._data)

    def grad(self):
        from ..parallel.mesh import mesh_size
        n_vox = 1
        for s in self.real_shape:
            n_vox *= s
        dtype = ("bfloat16"
                 if n_vox > self.BF16_VOXELS * mesh_size(self._mesh)
                 else "float32")
        if self._mesh is None:
            dims_vox = 1
            for s in self._args[0]:
                dims_vox *= s
            if self._final and dims_vox > 8_000_000:
                # Donation pays only at HBM-relevant sizes; small volumes
                # keep one program variant (and XLA:CPU cannot alias the
                # tiny test shapes anyway — donation would just warn).
                return _compiled_grad(*self._args, dtype=dtype,
                                      donate=True)(self._data)
            return _compiled_grad(*self._args, dtype=dtype)(self._data)
        return _compiled_grad(*self._args, dtype=dtype, mesh=self._mesh)(
            self._data)


def iter_lazy_octaves(grid: DensityGrid, cfg: ScaleSpaceConfig,
                      shape_bucket: int = 32, mesh=None):
    """Yield (origin, LazyOctave) per octave. With a mesh, the volume is
    spatially sharded for the filter programs (GSPMD)."""
    data, origin, real, dims = _prepare(grid, cfg, shape_bucket, mesh)
    # The last octave's gradient program may donate the shared padded
    # volume — but never the grid's own cached device buffer (zero
    # padding + already-bucketed shapes make _prepare a passthrough).
    own_buffer = data is not grid.__dict__.get("_device_data")
    last_up = cfg.oct_mode == "up"
    if cfg.oct_mode in ("up", "both"):
        yield origin, LazyOctave(data, dims, grid.voxsp / 2.0,
                                 tuple(2 * s - 1 for s in real), True, cfg,
                                 mesh, final=last_up and own_buffer)
    if cfg.oct_mode in ("base", "both"):
        yield origin, LazyOctave(data, dims, grid.voxsp, real, False, cfg,
                                 mesh, final=own_buffer)


def iter_octaves(grid: DensityGrid, cfg: ScaleSpaceConfig,
                 shape_bucket: int = 32):
    """Yield (origin, Octave) one octave at a time.

    Each octave compiles and runs as its own program so its working set
    (upsampled grid + LoG terms + gradients, ~10x the base volume for the
    upsampled octave) is freed before the next octave builds: peak memory
    is one octave's working set, not the sum over octaves.
    """
    data, origin, real, dims = _prepare(grid, cfg, shape_bucket)
    if cfg.oct_mode in ("up", "both"):
        fn = _compiled_build(dims, float(cfg.detect_sigma),
                             float(cfg.presmooth_sigma), "up",
                             float(cfg.truncate))
        log_resp, grad = fn(data)[0]
        yield origin, Octave(voxsp=grid.voxsp / 2.0, log=log_resp, grad=grad,
                             real_shape=tuple(2 * s - 1 for s in real))
        del log_resp, grad
    if cfg.oct_mode in ("base", "both"):
        fn = _compiled_build(dims, float(cfg.detect_sigma),
                             float(cfg.presmooth_sigma), "base",
                             float(cfg.truncate))
        log_resp, grad = fn(data)[0]
        yield origin, Octave(voxsp=grid.voxsp, log=log_resp, grad=grad,
                             real_shape=real)


def build_scale_space(grid: DensityGrid, cfg: ScaleSpaceConfig,
                      shape_bucket: int = 32) -> ScaleSpace:
    """Pad, bucket and filter a density grid into its octaves (all octaves
    resident at once; use ``iter_octaves`` for memory-bounded streaming)."""
    octaves = []
    origin = grid.origin
    for origin, octv in iter_octaves(grid, cfg, shape_bucket):
        octaves.append(octv)
    return ScaleSpace(octaves=octaves, origin=origin, name=grid.name)
