"""Bench-shape sharded dryrun: the fused dock path on a virtual 8-device
mesh at >= 128^3 map scale with >= 4 subunit copies.

Runs on the CPU platform with ``xla_force_host_platform_device_count=8`` —
the same harness the driver's ``dryrun_multichip`` uses — so it validates
that the PRODUCTION sharded pipeline (describe volume-SP + fused dock with
pair/lane DP, engine/dock_fused shard_map variants) compiles and executes
at north-star-like shapes without real multi-chip hardware. Wall times here
are CPU times, not projections of accelerator times.

Usage: python scripts/dryrun_bench_mesh.py [n_copies] [n_res] [spread]
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flag = "--xla_force_host_platform_device_count=8"
if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " " + _flag

import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main():
    import dataclasses

    from mad_tpu.api import _decoy_transform
    from mad_tpu.core.config import MadConfig
    from mad_tpu.engine.docking import dock_structure
    from mad_tpu.engine.pipeline import describe_grid, describe_structure
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.parallel.mesh import make_mesh
    from mad_tpu.testing import make_assembly

    n_copies = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_res = int(sys.argv[2]) if len(sys.argv) > 2 else 160
    spread = float(sys.argv[3]) if len(sys.argv) > 3 else 60.0

    cfg = MadConfig()
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                 rescue_rounds=1))
    mesh = make_mesh(8)

    t0 = time.time()
    sub, copies = make_assembly(n_copies=n_copies, n_res=n_res, seed=0,
                                spread=spread, shell=True)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 10.0, 1.4, masses=masses).reduce_void()
    print(f"mesh-bench> map {dmap.shape} "
          f"({np.prod(dmap.shape) / 1e6:.1f} M vox) built in "
          f"{time.time() - t0:.1f}s", flush=True)
    assert min(dmap.shape) >= 128, dmap.shape

    moved = _decoy_transform(sub)
    t0 = time.time()
    map_set = describe_grid(dmap, cfg, name="meshbench_map", mesh=mesh)
    sub_set = describe_structure(moved, 10.0, dmap.voxsp, cfg,
                                 name="meshbench_sub", mesh=mesh)
    print(f"mesh-bench> describe (sharded): {time.time() - t0:.1f}s, "
          f"{map_set.n} map / {sub_set.n} sub descriptors", flush=True)

    t0 = time.time()
    sols = dock_structure(map_set, sub_set, moved, dmap, 10.0, cfg,
                          n_copies=n_copies, verbose=False, mesh=mesh)
    t_dock = time.time() - t0
    rmsds = [min((s.structure.rmsd_ca_with(c) for s in sols),
                 default=np.inf) for c in copies]
    found = int(np.sum(np.asarray(rmsds) < 10.0))
    print(f"mesh-bench> dock (fused, sharded): {t_dock:.1f}s, "
          f"{len(sols)} solutions, {found}/{n_copies} recovered, "
          f"median best CA-RMSD {np.median(rmsds):.2f} A", flush=True)
    assert found == n_copies, (found, rmsds)


if __name__ == "__main__":
    main()
