import os

import numpy as np
import pytest

from mad_tpu import functional as F
from mad_tpu.core.config import MadConfig
from mad_tpu.core.grid import write_mrc
from mad_tpu.core.structure import write_pdb
from mad_tpu.ops.simulate import simulate_density
from mad_tpu.testing import make_assembly
from mad_tpu.utils import profiling


@pytest.fixture(scope="module")
def small_system(tmp_path_factory):
    root = tmp_path_factory.mktemp("func")
    sub, copies = make_assembly(n_copies=2, n_res=50, seed=7, spread=15.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses)
    map_path = str(root / "m.mrc")
    write_mrc(dmap, map_path)
    return map_path, copies


@pytest.mark.slow
def test_functional_pipeline(small_system):
    map_path, copies = small_system
    grid, cfg = F.setup(map_path, resolution=8.0)
    assert grid.voxsp == pytest.approx(2.0)
    map_set = F.get_descriptors(grid, 8.0, 2.0, cfg, name="m")
    assert map_set.n > 0
    sub = copies[0]
    sub_set = F.get_descriptors(sub, 8.0, 2.0, cfg, name="s")
    sols = F.match_and_dock(map_set, sub_set, sub, grid, 8.0, cfg,
                            n_copies=2)
    assert sols
    # benchmarking hook: solution x reference RMSD matrix
    bench = F.benchmark_solutions(sols, copies)
    assert bench.shape == (len(sols), 2)
    assert bench.min() < 3.0
    # repeatability diagnostics between the two descriptor sets
    rep = F.get_repeatability(map_set, sub_set)
    assert set(rep) == {2.0, 4.0, 6.0}


def test_functional_smoke_fast(tmp_path):
    """Fast-tier smoke of the core functional surface (ADVICE r4): setup ->
    get_descriptors -> match_and_dock on a one-copy system small enough for
    the fast tier; the full two-copy pipeline with benchmarking hooks stays
    in the slow tier above."""
    from mad_tpu.testing import make_protein

    sub = make_protein(n_res=40, seed=3)
    sub = sub.with_coords(sub.coords - sub.center())
    sim = simulate_density(sub.coords, 10.0, 2.5, masses=sub.masses)
    map_path = str(tmp_path / "smoke.mrc")
    write_mrc(sim, map_path)
    grid, cfg = F.setup(map_path, resolution=10.0)
    assert grid.voxsp == pytest.approx(2.5)
    map_set = F.get_descriptors(grid, 10.0, 2.5, cfg, name="smoke_m")
    sub_set = F.get_descriptors(sub, 10.0, 2.5, cfg, name="smoke_s")
    assert map_set.n > 0 and sub_set.n > 0
    sols = F.match_and_dock(map_set, sub_set, sub, grid, 10.0, cfg,
                            n_copies=1)
    assert sols
    assert min(s.structure.rmsd_ca_with(sub) for s in sols) < 3.0


def test_profiling_stage_accumulates():
    profiling.show_timing(reset=True)
    with profiling.stage("unit_test_stage"):
        sum(range(1000))
    with profiling.stage("unit_test_stage"):
        sum(range(1000))
    t = profiling.get_timings()
    assert "unit_test_stage" in t and t["unit_test_stage"] >= 0
    table = profiling.show_timing(reset=True)
    assert "unit_test_stage" in table
    assert "unit_test_stage" not in profiling.get_timings()


def test_profiling_stage_sync_waits_for_stage_outputs():
    import jax
    import jax.numpy as jnp
    profiling.show_timing(reset=True)
    f = jax.jit(lambda a: jnp.cumsum(a @ a.T, axis=0))
    with profiling.stage("sync_stage", sync=True) as fence:
        out = f(jnp.ones((256, 256)))
        fence.append(out)
    assert out.is_ready()
    assert profiling.get_timings()["sync_stage"] > 0
    profiling.show_timing(reset=True)
