"""On-card smoke check: mad_tpu's main path on one GPU, end to end.

Run from the checkout root:

    python chip_smoke.py               # one GPU (the first card)
    python chip_smoke.py --four-cards  # only the mesh path, on 4 GPUs

Everything runs in one process. Without --four-cards the phases are:

  1. device check: the first JAX device must be a GPU; otherwise the script
     exits 2 and prints no result. The card's name and power limit
     (nvidia-smi) are printed once and stand beside every number below;
  2. main path through the session API, cold (compile included): the
     bench.py system (10 copies, 10 A map, subunit at the decoy pose)
     written to MRC + PDB, then MaD.add_map / add_subunit / run /
     build_assembly. Every copy must be recovered at best CA-RMSD <= 2 A,
     median <= 0.5 A, with assembly models written;
  3. descriptor similarity at the precision the matcher names, against a
     float64 product of the session's own descriptor sets;
  4. steady pass: bench.run_fit best of 5, as bench.py times it, with the
     stage timers, the peak device bytes and the compiled memory of the
     fused octave-0 describe chain;
  5. per-choice comparisons at octave-0 width (the bench map upsampled x2)
     against plain host references: x2 upsampling, separable convolutions,
     seed collection, trilinear gathers of the refiner.

With --four-cards the script runs only the MaD(mesh="auto") session over
all local GPUs and the same system with mesh=None, and compares their
solutions as the mesh-equality tests do.

Any failed check raises, so the exit code is non-zero. The last line of
standard output is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

# The bench cell: bench.build_system()'s defaults and the map resolution.
SYSTEM = dict(n_copies=10, n_res=260, voxsp=1.4, resolution=10.0,
              spread=115.0)
RMSD_BEST_MAX = 2.0        # A, every copy
RMSD_MEDIAN_MAX = 0.5      # A
STEADY_PASSES = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """A failed check raises (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def require_gpu():
    """The first device, which must be a GPU: no fallback to the CPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU found (JAX platform "
                         f"{devs[0].platform!r}); this check runs only on a "
                         "GPU\n")
        raise SystemExit(2)
    return devs


def build_cfg():
    import dataclasses
    from mad_tpu.core.config import MadConfig
    cfg = MadConfig()
    # bench.py's knobs: one rescue round on top of the reference defaults.
    return cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                  rescue_rounds=1))


def build_system():
    import bench
    s = SYSTEM
    return bench.build_system(n_copies=s["n_copies"], n_res=s["n_res"],
                              voxsp=s["voxsp"], resolution=s["resolution"],
                              spread=s["spread"])


def best_rmsds(sols, copies):
    return [min((s.structure.rmsd_ca_with(c) for s in sols),
                default=np.inf) for c in copies]


def check_recovery(rmsds, what: str) -> None:
    r = np.asarray(rmsds)
    log(f"{what}: {int(np.sum(r <= RMSD_BEST_MAX))}/{len(r)} copies at "
        f"best CA-RMSD <= {RMSD_BEST_MAX} A, median {np.median(r):.3f} A, "
        f"max {r.max():.3f} A (limits: every copy <= {RMSD_BEST_MAX} A, "
        f"median <= {RMSD_MEDIAN_MAX} A)")
    check(np.all(r <= RMSD_BEST_MAX), f"{what}: copy not recovered: {r}")
    check(np.median(r) <= RMSD_MEDIAN_MAX, f"{what}: median {np.median(r)}")


def run_session(cfg, system, workdir: str, mesh=None):
    """Write the system to MRC + PDB and fit it through the session API.
    Returns (session, wall seconds)."""
    from mad_tpu.api import MaD
    from mad_tpu.core.grid import write_mrc
    from mad_tpu.core.structure import write_pdb
    import bench

    sub, _copies, dmap = system
    os.makedirs(workdir, exist_ok=True)
    map_path = os.path.join(workdir, "bench_map.mrc")
    sub_path = os.path.join(workdir, "bench_sub.pdb")
    write_mrc(dmap, map_path)
    write_pdb(bench.decoy(sub), sub_path)
    # A descriptor-cache hit must not stand in for compute.
    shutil.rmtree(os.path.join(workdir, "dsc_db"), ignore_errors=True)
    shutil.rmtree(os.path.join(workdir, "pose_db"), ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        mad = MaD(workdir, config=cfg, mesh=mesh)
        mad.add_map(map_path, resolution=SYSTEM["resolution"])
        mad.add_subunit(sub_path, n_copies=SYSTEM["n_copies"])
        mad.run()
        mad.build_assembly()
    return mad, time.perf_counter() - t0


def phase_main_path(cfg, system, workdir, card):
    mad, wall = run_session(cfg, system, workdir)
    sols = mad.solutions["bench_sub"]
    check_recovery(best_rmsds(sols, system[1]), "main path (MaD session)")
    models = os.path.join(mad.out_folder, "assembly_models")
    n_models = len(os.listdir(models)) if os.path.isdir(models) else 0
    log(f"main path: {len(sols)} solutions, {n_models} files in "
        "assembly_models/")
    check(n_models >= 1, "no assembly model written")
    log(f"main path cold wall time (compile included): {wall:.3f} s "
        f"[{card}]")
    return mad


def phase_similarity(mad, card):
    import jax
    import jax.numpy as jnp
    from mad_tpu.engine import match

    hi_set, lo_set = mad.dsc_dict["bench_sub"], mad.map_dsc
    hi = np.asarray(hi_set.desc_norm)[:hi_set.n]
    lo = np.asarray(lo_set.desc_norm)[:lo_set.n]
    fn = jax.jit(lambda a, b: jnp.dot(
        a, b.T, precision=match.SIMILARITY_PRECISION,
        preferred_element_type=jnp.float32))
    got = np.asarray(fn(hi, lo), np.float64)
    ref = hi.astype(np.float64) @ lo.astype(np.float64).T
    err = float(np.max(np.abs(got - ref)))
    thr = mad.config.match.cc_threshold
    clear = np.abs(ref - thr) > 1e-4
    same = bool(np.all(((got > thr) == (ref > thr))[clear]))
    hlo = fn.lower(hi, lo).compile().as_text()
    prec = re.search(r'"operand_precision":\[[^\]]*\][^}]*', hlo)
    log(f"similarity ({hi.shape[0]} x {lo.shape[0]} x {hi.shape[1]}): "
        f"precision {match.SIMILARITY_PRECISION}, compiled "
        f"{prec.group(0) if prec else 'dot'}; max |cos err| vs float64 "
        f"{err:.3e} (tolerance 1e-4); pairs above {thr} equal outside the "
        f"+-1e-4 band: {same} [{card}]")
    check(err <= 1e-4 and same, "similarity outside its tolerance")


def phase_steady(cfg, system, card):
    import jax
    import bench
    from mad_tpu.utils import profiling
    from mad_tpu.utils.warmup import replay

    sub, copies, dmap = system
    res = SYSTEM["resolution"]
    with contextlib.redirect_stdout(sys.stderr):
        bench.run_fit(sub, copies, dmap, res, cfg)     # bench.py's warm-up
        replay(block=True)
        profiling.show_timing(reset=True)
    elapsed = float("inf")
    for _ in range(STEADY_PASSES):
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            sols, n_models = bench.run_fit(sub, copies, dmap, res, cfg)
        t = time.time() - t0
        log(f"steady pass: {t:.4f} s [{card}]")
        elapsed = min(elapsed, t)
    with contextlib.redirect_stdout(sys.stderr):
        timers = profiling.show_timing(reset=True)
    check_recovery(best_rmsds(sols, copies), "steady pass (bench.run_fit)")
    log(f"steady pass best of {STEADY_PASSES}: {elapsed:.4f} s, "
        f"{len(sols)} solutions, {n_models} models [{card}]")
    log("stage timers over the timed passes (s): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(timers.items(),
                                           key=lambda kv: -kv[1])}))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"peak device bytes in use (process, up to here): {peak} [{card}]")
    octave_memory(cfg, dmap, card)


def octave_memory(cfg, dmap, card):
    """Compiled memory of the fused octave chains at the bench map's shape:
    the per-voxel figure the device-memory gates are derived from."""
    from mad_tpu.utils.warmup import pipeline_programs
    from mad_tpu.ops.scalespace import iter_lazy_octaves

    octs = {o._args[3]: o for _origin, o in iter_lazy_octaves(
        dmap, cfg.scalespace, cfg.shape_bucket)}
    chains = {}
    for fn, args in pipeline_programs(tuple(dmap.shape), cfg):
        if "octave_chain" in getattr(fn, "_qual", ""):
            chains.setdefault(fn._args[3], (fn, args))    # static arg: up
    for up, (fn, args) in sorted(chains.items(), reverse=True):
        octv = octs[up]
        ma = fn.lower(*args).compile().memory_analysis()
        n_real = int(np.prod(octv.real_shape))
        total = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                 + ma.output_size_in_bytes)
        log(f"fused chain {tuple(octv.real_shape)}: temp "
            f"{ma.temp_size_in_bytes} B, args {ma.argument_size_in_bytes} "
            f"B, out {ma.output_size_in_bytes} B = {total / n_real:.2f} B "
            f"per real octave voxel [{card}]")


def _time_ms(fn, *args, n: int = 10) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _catmull_rom_up(x: np.ndarray, axis: int) -> np.ndarray:
    """float64 x2 upsampling along one axis (original samples on even
    indices, edge-replicated Catmull-Rom half samples on odd ones)."""
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    i = np.arange(n - 1)
    at = lambda j: x[..., np.clip(j, 0, n - 1)]
    out = np.empty(x.shape[:-1] + (2 * n - 1,), np.float64)
    out[..., 0::2] = x
    out[..., 1::2] = (-at(i - 1) + 9 * at(i) + 9 * at(i + 1)
                      - at(i + 2)) / 16.0
    return np.moveaxis(out, -1, axis)


def _rel_err(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def phase_choices(cfg, system, card):
    import jax
    import jax.numpy as jnp
    from scipy import ndimage
    from scipy.interpolate import RegularGridInterpolator
    from mad_tpu.ops import convolve as cv
    from mad_tpu.ops.detect import collect_peaks
    from mad_tpu.ops.interp import pack_corners, trilinear, trilinear_packed
    from mad_tpu.ops.scalespace import iter_lazy_octaves

    _sub, _copies, dmap = system
    ss = cfg.scalespace
    _origin, octv = next(iter_lazy_octaves(dmap, ss, cfg.shape_bucket))
    base = octv._data

    # x2 upsampling (octave 0's input) against float64 Catmull-Rom.
    up_fn = jax.jit(cv.upsample2)
    up = up_fn(base)
    ref = np.asarray(base, np.float64)
    for a in range(3):
        ref = _catmull_rom_up(ref, a)
    err = _rel_err(np.asarray(up, np.float64), ref)
    del ref
    log(f"upsample2 {tuple(base.shape)} -> {tuple(up.shape)} "
        f"({int(np.prod(up.shape))} voxels): float32 shift-add, max err "
        f"{err:.2e} of max |ref| (tolerance 1e-5); {_time_ms(up_fn, base):.3f}"
        f" ms [{card}]")
    check(err <= 1e-5, "upsample2 outside its tolerance")

    # One 17-tap Gaussian per axis against scipy's correlate1d (float64).
    up_h = np.asarray(up)
    k = cv.gaussian_kernel1d(ss.detect_sigma, 0, ss.truncate)
    for axis in range(3):
        fn = jax.jit(lambda v, a=axis: cv.conv1d_along(v, k, a))
        got = np.asarray(fn(up))
        ref = ndimage.correlate1d(up_h, k[::-1].astype(np.float64),
                                  axis=axis, mode="constant",
                                  output=np.float64)
        err = _rel_err(got.astype(np.float64), ref)
        del got, ref
        log(f"conv1d_along axis {axis}, {k.size} taps: float32 shift-add, "
            f"max err {err:.2e} of max |ref| (tolerance 1e-5); "
            f"{_time_ms(fn, up):.3f} ms [{card}]")
        check(err <= 1e-5, f"conv1d_along axis {axis} outside its tolerance")
    del up_h

    # Seed collection on the octave-0 LoG against the host reference.
    log_fn = jax.jit(lambda v: cv.log_filter3d(
        cv.gaussian_filter3d(v, ss.presmooth_sigma, ss.truncate),
        ss.detect_sigma, ss.truncate)[0])
    log0 = log_fn(up)
    log(f"presmooth + log_filter3d at octave 0: {_time_ms(log_fn, up):.3f} "
        f"ms [{card}]")
    det = cfg.detect
    args = (tuple(octv.real_shape), float(det.threshold_abs),
            int(det.exclude_border), int(det.max_anchors))
    peaks_fn = jax.jit(lambda v: collect_peaks(v, *args))
    vals, idx = (np.asarray(a) for a in peaks_fn(log0))
    vol = np.asarray(log0)
    pooled = ndimage.maximum_filter(vol, size=3, mode="constant",
                                    cval=-np.inf)
    rx, ry, rz = octv.real_shape
    eb = det.exclude_border
    peak = vol >= pooled
    del pooled
    peak &= vol > det.threshold_abs
    inside = np.zeros(vol.shape, bool)
    inside[eb:rx - eb, eb:ry - eb, eb:rz - eb] = True
    peak &= inside
    scores = np.where(peak, vol, -np.inf).ravel()
    n_ref = int(min(det.max_anchors, peak.sum()))
    ref_idx = np.argpartition(-scores, n_ref - 1)[:n_ref]
    got_idx = idx[np.isfinite(vals)]
    same = set(got_idx.tolist()) == set(ref_idx.tolist())
    log(f"collect_peaks at octave 0 ({vol.size} voxels): {got_idx.size} "
        f"seeds, index set equal to the host np.argpartition reference: "
        f"{same} (tolerance: exact); {_time_ms(peaks_fn, log0):.3f} ms "
        f"[{card}]")
    check(same and np.array_equal(vals[:n_ref], scores[idx[:n_ref]]),
          "collect_peaks differs from the host reference")
    del vol, scores, peak, inside, log0, up

    # Trilinear gathers of the refiner at the bench's candidate frame.
    m = dmap.device()
    field = jnp.stack(jnp.gradient(m), axis=-1)
    shp = tuple(m.shape)
    packed = pack_corners(field)
    rng = np.random.default_rng(0)
    c, n = 48, 1280                  # dock candidate frame x subunit atoms
    pts = rng.uniform(0.0, np.asarray(shp) - 1.0, size=(c, n, 3)
                      ).astype(np.float32)
    plain = np.asarray(jax.jit(trilinear)(field, pts))
    pk = np.asarray(jax.jit(trilinear_packed, static_argnums=1)(
        packed, shp, pts))
    axes = [np.arange(s, dtype=np.float64) for s in shp]
    ref = RegularGridInterpolator(axes, np.asarray(field, np.float64))(
        pts.reshape(-1, 3).astype(np.float64)).reshape(pk.shape)
    err = _rel_err(plain.astype(np.float64), ref)
    log(f"trilinear ({c} x {n} points): max err {err:.2e} of max |ref| "
        f"(tolerance 1e-5); packed == plain: {np.array_equal(pk, plain)} "
        f"(max diff {np.max(np.abs(pk - plain)):.1e}, tolerance 1e-6)")
    check(err <= 1e-5 and np.max(np.abs(pk - plain)) <= 1e-6,
          "trilinear gathers outside their tolerance")

    def steps(use_packed):
        # The table is an argument: as a closure constant it would be
        # baked into the executable.
        def run(p, table):
            def body(_, q):
                g = (trilinear_packed(table, shp, q) if use_packed
                     else trilinear(table, q))
                return q + 0.01 * jnp.tanh(g)
            return jax.lax.fori_loop(0, 500, body, p)
        return jax.jit(run)

    t_pk = _time_ms(steps(True), pts, packed, n=5)
    t_pl = _time_ms(steps(False), pts, field, n=5)
    log(f"500 dependent gather steps, {c} x {n} points: packed "
        f"{t_pk:.3f} ms, plain {t_pl:.3f} ms [{card}]")


def phase_four_cards(cfg, system, card):
    """The MaD(mesh="auto") session over all local GPUs against the same
    system with mesh=None, compared as the mesh-equality tests do."""
    import jax
    n = len(jax.devices())
    check(n >= 2, f"--four-cards needs several GPUs, found {n}")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        single, t1 = run_session(cfg, system, os.path.join(root, "single"))
        meshed, t4 = run_session(cfg, system, os.path.join(root, "mesh"),
                                 mesh="auto")
        s1 = single.solutions["bench_sub"]
        s4 = meshed.solutions["bench_sub"]
        log(f"mesh over {n} devices: {len(s4)} solutions in {t4:.3f} s cold; "
            f"mesh=None: {len(s1)} solutions in {t1:.3f} s cold [{card}]")
        check(len(s1) == len(s4) >= SYSTEM["n_copies"],
              f"solution counts differ: {len(s1)} vs {len(s4)}")
        worst = dict(coords=0.0, repeat=0.0, ccc=0.0)
        for a, b in zip(s1, s4):
            worst["coords"] = max(worst["coords"], float(np.max(np.abs(
                b.structure.coords - a.structure.coords))))
            worst["repeat"] = max(worst["repeat"], abs(b.repeat - a.repeat))
            worst["ccc"] = max(worst["ccc"], abs(b.ccc - a.ccc))
            check(b.weight == a.weight, "cluster weights differ")
        log(f"mesh vs single: max |coords| diff {worst['coords']:.2e} A "
            f"(tolerance 1e-3), max |repeat| diff {worst['repeat']:.2e} "
            f"(1e-3), max |CCC| diff {worst['ccc']:.2e} (1e-4), weights "
            "equal")
        check(worst["coords"] <= 1e-3 and worst["repeat"] <= 1e-3
              and worst["ccc"] <= 1e-4, "mesh differs from mesh=None")
        check_recovery(best_rmsds(s4, system[1]), "mesh session")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def optional_imports() -> str:
    import importlib.util
    absent = [m for m in ("h5py", "matplotlib", "sklearn")
              if importlib.util.find_spec(m) is None]
    return ", ".join(absent) if absent else "none"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path over all local GPUs")
    opts = ap.parse_args(argv)

    devs = require_gpu()
    import jax
    from mad_tpu.utils.profiling import card_info

    card = ", ".join(card_info().splitlines())
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
        f"optional modules absent: {optional_imports()}")
    cfg = build_cfg()
    t0 = time.perf_counter()
    system = build_system()
    log(f"bench system: map {system[2].shape} at {system[2].voxsp} A, "
        f"{len(system[1])} copies, built in {time.perf_counter() - t0:.2f} s")

    if opts.four_cards:
        phase_four_cards(cfg, system, card)
    else:
        root = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            mad = phase_main_path(cfg, system, root, card)
            phase_similarity(mad, card)
            del mad
        finally:
            shutil.rmtree(root, ignore_errors=True)
        phase_steady(cfg, system, card)
        phase_choices(cfg, system, card)

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
