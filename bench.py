"""End-to-end benchmark: rigid fit of a 10-subunit assembly, ~256^3 map.

The founding brief (BASELINE.md) set a 60 s target for the full fit at
RMSD/CC parity; the reference publishes no timing numbers, so
vs_baseline = 60 / measured_seconds (higher is better).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "card",
"power_limit", "platform", "device_kind", "device_count"}; the last five
name the device the number was taken on. Run: python bench.py
"""

import json
import sys
import time

import numpy as np


def build_system(n_copies=10, n_res=260, voxsp=1.4, resolution=10.0,
                 spread=115.0, seed=0):
    from mad_tpu.testing import make_assembly
    from mad_tpu.ops.simulate import simulate_density

    t0 = time.time()
    sub, copies = make_assembly(n_copies=n_copies, n_res=n_res, seed=seed,
                                spread=spread, shell=True)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    t1 = time.time()
    dens = simulate_density(coords, resolution, voxsp, masses=masses)
    t2 = time.time()
    dmap = dens.reduce_void()
    sys.stderr.write(f"bench> build: assembly {t1 - t0:.1f}s simulate "
                     f"{t2 - t1:.1f}s reduce_void {time.time() - t2:.1f}s\n")
    return sub, copies, dmap


def decoy(sub):
    """Rotated + translated decoy pose (host-side numpy, deterministic)."""
    from mad_tpu.api import _decoy_transform
    return _decoy_transform(sub)


def run_fit(sub, copies, dmap, resolution, cfg):
    """Describe map + subunit, dock n_copies, enumerate assembly."""
    from mad_tpu.engine.pipeline import describe_grid, describe_structure
    from mad_tpu.engine.docking import dock_structure
    from mad_tpu.engine import assemble as asm
    from mad_tpu.utils.profiling import stage

    from mad_tpu.engine.pipeline import describe_many

    n_copies = len(copies)
    # Decoy transform (self-fit protocol, reference run_MaD.py path with
    # transform_subunits=True): full rotation + translation away from the
    # deposited pose (mad/structure_utils.py:30-56) so recovery exercises
    # the descriptor/orientation rotation invariance, not just translation.
    moved = decoy(sub)
    # Map and subunit describe chains are independent: threading them
    # overlaps their host work (engine/pipeline.describe_many).
    with stage("bench.describe"):
        map_set, sub_set = describe_many([
            lambda: describe_grid(dmap, cfg, name="bench_map"),
            lambda: describe_structure(moved, resolution, dmap.voxsp, cfg,
                                       name="bench_sub"),
        ])
    with stage("bench.dock"):
        sols = dock_structure(map_set, sub_set, moved, dmap, resolution, cfg,
                              n_copies=n_copies, verbose=False)
    n_models = 0
    if len(sols) >= 2:
        structures = [s.structure for s in sols]
        with stage("bench.overlap_matrix"):
            # defer=True: the matrix stays on device and chains into the
            # enumeration head; one host sync instead of two.
            overlap = asm.solution_overlap(structures, cfg.assembly,
                                           defer=True)
        with stage("bench.enumerate"):
            tuples, sums, stds, maxs = asm.enumerate_homomultimer(
                len(sols), min(n_copies, len(sols)), overlap)
        with stage("bench.score_models"):
            models = asm.score_models(tuples, sums, stds, maxs, structures,
                                      dmap, cfg.assembly, 10, 0.1)
        n_models = len(models)
    return sols, n_models


def accuracy(sols, copies):
    """Best CA-RMSD of each true pose against the solution set."""
    rmsds = []
    for c in copies:
        best = min((s.structure.rmsd_ca_with(c) for s in sols),
                   default=np.inf)
        rmsds.append(best)
    return rmsds


def main():
    import dataclasses
    from mad_tpu.core.config import MadConfig

    cfg = MadConfig()
    # Rescue rounds are opt-in (default 0 = reference-parity output); the
    # bench exercises the full capability surface.
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                 rescue_rounds=1))
    # Staged warm: the map-build chain (simulate + grid crop) compiles
    # ALONE first, so the programs the main thread needs first do not
    # queue behind the thirty-odd describe/dock compiles. The full replay
    # starts right after the build dispatches.
    from mad_tpu.utils.warmup import replay
    replay(block=False, only=("simulate", "grid"))
    t0 = time.time()
    sub, copies, dmap = build_system()
    replay(block=False)
    sys.stderr.write(f"bench> map {dmap.shape} built in "
                     f"{time.time() - t0:.1f}s\n")

    # Concurrent AOT compile of the describe-side programs: the compiles
    # overlap on a thread pool instead of serializing through first use.
    from mad_tpu.ops.simulate import simulated_shape
    from mad_tpu.utils.warmup import warm_pipeline
    t0 = time.time()
    sub_shape = simulated_shape(decoy(sub).coords, 10.0, dmap.voxsp,
                                shape_bucket=cfg.shape_bucket)
    warm_pipeline([dmap.shape, sub_shape], cfg)
    sys.stderr.write(f"bench> AOT warm: {time.time() - t0:.1f}s\n")

    # Warm-up pass: compiles the remaining (data-dependent-shape) kernels.
    t0 = time.time()
    sols, n_models = run_fit(sub, copies, dmap, 10.0, cfg)
    sys.stderr.write(f"bench> warmup (incl. compile): "
                     f"{time.time() - t0:.1f}s, {len(sols)} solutions, "
                     f"{n_models} models\n")

    # Join any warm work still in flight before timing: async replays can
    # lag past the warmup pass and bleed first executions into the timed
    # window (in-flight futures dedupe, so a second replay of warm
    # programs is cheap).
    t0 = time.time()
    replay(block=True)
    sys.stderr.write(f"bench> warm barrier: {time.time() - t0:.1f}s\n")

    # Timed steady-state: best of five passes (the minimum is the
    # reproducible floor; five samples pin it better than three).
    import contextlib
    from mad_tpu.utils import profiling
    with contextlib.redirect_stdout(sys.stderr):
        profiling.show_timing(reset=True)
    elapsed = float("inf")
    for _ in range(5):
        t0 = time.time()
        sols, n_models = run_fit(sub, copies, dmap, 10.0, cfg)
        t = time.time() - t0
        sys.stderr.write(f"bench> timed pass: {t:.2f}s\n")
        elapsed = min(elapsed, t)
    with contextlib.redirect_stdout(sys.stderr):
        profiling.show_timing()
    rmsds = accuracy(sols, copies)
    found = int(np.sum(np.asarray(rmsds) < 10.0))
    sys.stderr.write(
        f"bench> timed: {elapsed:.2f}s, {len(sols)} solutions, "
        f"{found}/{len(copies)} subunits recovered, "
        f"median best CA-RMSD {np.median(rmsds):.2f} A\n")

    import jax
    from mad_tpu.utils.profiling import card_info
    dev = jax.devices()[0]
    card = card_info().splitlines()[0].split(",")
    print(json.dumps({
        "metric": "e2e_fit_10sub_256cube_seconds",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(60.0 / max(elapsed, 1e-9), 3),
        "card": card[0].strip(),
        "power_limit": card[1].strip() if len(card) > 1 else "not available",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
