"""Device-mesh helpers.

The reference is single-process NumPy with no distribution of any kind
(SURVEY.md section 2); multi-chip scaling here is a new first-class
component: volumes shard spatially (XLA GSPMD inserts halo exchanges for the
separable convolutions), and the embarrassingly parallel axes (descriptor
pairs, pose candidates) shard as data parallelism with collective top-k /
gather reductions between devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def auto_mesh(axis: str = "x") -> Optional[Mesh]:
    """Mesh over all local devices; None when only one device exists (the
    single-device kernels need no collective plumbing)."""
    devs = jax.devices()
    if len(devs) < 2:
        return None
    return Mesh(np.asarray(devs), (axis,))


def mesh_axis(mesh: Mesh) -> str:
    return mesh.axis_names[0]


def mesh_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def batch_bucket(n: int, base: int, mesh: Optional[Mesh]) -> int:
    """Round a batch size up so every device gets whole ``base``-sized
    chunks: the smallest multiple of base * mesh_size >= n."""
    step = base * mesh_size(mesh)
    return ((int(n) + step - 1) // step) * step


# jax 0.9 implements all_gather_invariant but does not export it.
from jax._src.lax.parallel import all_gather_invariant as gather_invariant


def pvary(x, axis: str):
    """Promote a replicated value to varying over ``axis`` (VMA cast) so
    shard_map's varying-manual-axes check accepts loops whose carries mix
    replicated inits with shard-varying updates."""
    return jax.lax.pcast(x, axis, to="varying")


def volume_sharding(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Shard a 3D volume along its first spatial axis."""
    return NamedSharding(mesh, P(axis, None, None))


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "x") -> NamedSharding:
    """Shard the leading (batch) axis of an array."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
