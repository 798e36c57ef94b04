"""Roofline accounting for the bench-scale hot programs.

For each describe chain on the bench system (10 copies, ~256^3 map):
  * device time: min over REPS timed calls, each fenced by
    block_until_ready (the min is the reproducible floor);
  * XLA cost analysis (compiled.cost_analysis()): flops + bytes accessed;
  * share of the card's published peaks (PEAKS, keyed by device_kind).

Needs a GPU; writes a markdown table to stdout. Diagnostic only - not part
of the test suite. Run: python scripts/roofline.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Published dense peaks per device_kind: (f32 FLOP/s outside the tensor
# cores, bf16 tensor-core FLOP/s, device-memory bytes/s). Source: NVIDIA
# H100 data sheet, SXM5 part, dense rates without sparsity, at the 700 W
# power limit. A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 989e12, 3.35e12),
}
REPS = 5


def timed(fn, args, label, rows, flops_scale=1.0):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    flops = bytes_acc = None
    try:
        ca = fn.lower(*args).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        flops = ca.get("flops", 0.0) * flops_scale
        bytes_acc = ca.get("bytes accessed", 0.0)
    except Exception as e:
        sys.stderr.write(f"cost_analysis failed for {label}: {e}\n")
    rows.append((label, best, flops, bytes_acc))
    f = f"{flops/1e9:.1f}" if flops else "?"
    b = f"{bytes_acc/1e9:.2f}" if bytes_acc else "?"
    sys.stderr.write(f"roofline> {label}: {best*1e3:.1f} ms, "
                     f"{f} GF, {b} GB\n")
    return out


def peaks_for(device) -> tuple:
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise SystemExit(f"roofline: no published peaks for "
                         f"{device.device_kind!r}; add them to PEAKS")


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"roofline: needs a GPU, found {dev.platform}")
    peak_f32, peak_bf16, peak_mem = peaks_for(dev)
    from mad_tpu.core.config import MadConfig
    from mad_tpu.ops.scalespace import iter_lazy_octaves
    from mad_tpu.engine import pipeline as pl
    from bench import build_system

    cfg = MadConfig()
    # Staged AOT warm (same protocol as bench.py): map-build programs
    # first, then the whole manifest.
    from mad_tpu.utils.warmup import replay
    replay(block=False, only=("simulate", "grid"))
    sub, copies, dmap = build_system()
    replay(block=False)
    sys.stderr.write(f"map {dmap.shape}\n")

    rows = []
    spec_k, lane_cap = pl._frames_adopt(
        f"bench_map|{tuple(dmap.shape)}", (512, 2048))
    sys.stderr.write(f"frames: spec_k={spec_k} lane_cap={lane_cap}\n")
    radius = (cfg.orient.patch_size - cfg.orient.patch_size % 2) // 2
    dsc_radius = (cfg.describe.patch_size - cfg.describe.patch_size % 2) // 2

    det = cfg.detect

    oi = -1
    for origin, octv in iter_lazy_octaves(dmap, cfg.scalespace,
                                          cfg.shape_bucket):
        oi += 1
        dims_a, s_i, s_p, up_a, tr = octv._args
        fn = pl._compiled_octave_chain(
            tuple(dims_a), float(s_i), float(s_p), bool(up_a), float(tr),
            tuple(octv.real_shape), float(det.threshold_abs),
            int(det.exclude_border), float(det.max_offset),
            int(det.newton_iters), int(det.max_anchors), int(spec_k),
            int(radius), cfg.orient.eqsp_size, cfg.orient.max_main,
            cfg.orient.max_sec, float(cfg.orient.cutoff_magn),
            float(cfg.orient.gw_sig), cfg.describe.subeqsp_size,
            cfg.describe.subregions, float(cfg.describe.cutoff_magn),
            float(cfg.describe.zero_magn), int(lane_cap),
            dsc_radius=int(dsc_radius))
        timed(fn, (octv._data,), f"map oct{oi} chain "
              f"{tuple(octv.real_shape)} up={bool(up_a)}", rows)
        del octv

    # Subunit describe chain (smaller volume, same programs).
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.api import _decoy_transform
    moved = _decoy_transform(sub)
    sgrid = simulate_density(moved, 10.0, dmap.voxsp,
                             shape_bucket=cfg.shape_bucket)
    skey = f"bench_sub|{tuple(sgrid.shape)}"
    sk, sl = pl._frames_adopt(skey, (512, 2048))
    oi = -1
    for origin, octv in iter_lazy_octaves(sgrid, cfg.scalespace,
                                          cfg.shape_bucket):
        oi += 1
        dims_a, s_i, s_p, up_a, tr = octv._args
        fn = pl._compiled_octave_chain(
            tuple(dims_a), float(s_i), float(s_p), bool(up_a), float(tr),
            tuple(octv.real_shape), float(det.threshold_abs),
            int(det.exclude_border), float(det.max_offset),
            int(det.newton_iters), int(det.max_anchors), int(sk),
            int(radius), cfg.orient.eqsp_size, cfg.orient.max_main,
            cfg.orient.max_sec, float(cfg.orient.cutoff_magn),
            float(cfg.orient.gw_sig), cfg.describe.subeqsp_size,
            cfg.describe.subregions, float(cfg.describe.cutoff_magn),
            float(cfg.describe.zero_magn), int(sl),
            dsc_radius=int(dsc_radius))
        timed(fn, (octv._data,), f"sub oct{oi} chain "
              f"{tuple(octv.real_shape)} up={bool(up_a)}", rows)
        del octv

    print(f"\n{dev.device_kind}: peaks {peak_f32/1e12:.0f} TFLOP/s f32, "
          f"{peak_bf16/1e12:.0f} TFLOP/s bf16, {peak_mem/1e12:.2f} TB/s")
    print("\n| program | time (ms) | GFLOP | GB touched | TFLOP/s | GB/s | "
          "% f32 peak | % memory peak |")
    print("|---|---|---|---|---|---|---|---|")
    for label, t, flops, bytes_acc in rows:
        if flops is not None:
            tf = flops / t / 1e12
            gbs = bytes_acc / t / 1e9
            print(f"| {label} | {t*1e3:.1f} | {flops/1e9:.1f} | "
                  f"{bytes_acc/1e9:.2f} | {tf:.2f} | {gbs:.0f} | "
                  f"{100*flops/t/peak_f32:.1f}% | "
                  f"{100*bytes_acc/t/peak_mem:.1f}% |")
        else:
            print(f"| {label} | {t*1e3:.1f} | ? | ? | ? | ? | ? | ? |")


if __name__ == "__main__":
    main()
