"""One full multi-chip docking step over a device mesh (dry-run target).

Runs the PRODUCTION pipeline with a mesh — the exact code path
``api.MaD(mesh=...)`` routes through — on a small synthetic self-fit system:
  * describe: scale space on the spatially sharded volume (SP: XLA GSPMD
    halo exchange), anchor orientation + descriptors shard_map'ed over the
    anchor/lane axes (DP);
  * dock: descriptor similarity with the subunit rows sharded (GSPMD matmul
    + global top-k across devices), pair repeatability shard_map'ed over the
    pair axis (DP), rigid refinement shard_map'ed over pose candidates (DP).

This is the step the driver compile-checks with
``xla_force_host_platform_device_count`` (no real multi-chip needed); the
same sharded stages are equality-tested against the single-device kernels in
tests/test_parallel.py.
"""

from __future__ import annotations

import numpy as np

from .mesh import make_mesh


def multichip_step(n_devices: int, n_res: int = 40, seed: int = 3,
                   resolution: float = 8.0, voxsp: float = 2.0) -> int:
    """Describe + dock a small synthetic dimer with every stage sharded
    over an n-device mesh; returns the number of solutions found."""
    import dataclasses

    from ..core.config import MadConfig
    from ..engine.docking import dock_structure
    from ..engine.pipeline import describe_grid
    from ..ops.simulate import simulate_density
    from ..testing import make_assembly

    mesh = make_mesh(n_devices)
    cfg = MadConfig()
    # Tiny-system capacity (a config knob, same kernels): the dry run's
    # ~200 anchors don't need the production 4096-lane buffer, which on a
    # virtual CPU mesh costs real single-core minutes.
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))

    sub, copies = make_assembly(n_copies=2, n_res=n_res, seed=seed,
                                spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, resolution, voxsp, masses=masses,
                            shape_bucket=cfg.shape_bucket)
    sub_grid = simulate_density(sub, resolution, voxsp,
                                shape_bucket=cfg.shape_bucket)

    map_dsc = describe_grid(dmap, cfg, name="map", mesh=mesh)
    sub_dsc = describe_grid(sub_grid, cfg, name="sub", mesh=mesh)
    sols = dock_structure(map_dsc, sub_dsc, sub, dmap, resolution, cfg,
                          n_copies=2, verbose=False, mesh=mesh)
    return len(sols)
