"""Degradation ladder to failure (round-4 verdict item 3).

Sweeps experimental-map degradations — SNR ladder, B-factor-style blur,
anisotropic z-smear — over the 3-copy 10 A self-fit system at the
reference's noisy-system knobs (run_MaD.py:43-47), and prints a markdown
table for PARITY.md. Runs on the GPU (MAD_TPU_CPU=1: on the host);
tests/test_degradation.py pins the mid-ladder point as a regression.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Opt-in CPU run (MAD_TPU_CPU=1): force the platform via the env var and
# jax.config before any jax use (same pattern as
# scripts/dryrun_bench_mesh.py).
if os.environ.get("MAD_TPU_CPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

import numpy as np

from mad_tpu.testing import DEGRADATION_LADDER, run_degraded


def main():
    rows = []
    for point in DEGRADATION_LADDER:
        t0 = time.time()
        res = run_degraded(point)
        dt = time.time() - t0
        med = np.median([r for r in res["rmsds"] if np.isfinite(r)])
        rows.append((res["name"], res["recovered"], res["n_copies"],
                     med, res["n_solutions"], dt))
        print(f"ladder> {res['name']}: {res['recovered']}/"
              f"{res['n_copies']} recovered, median best RMSD {med:.2f} A, "
              f"{res['n_solutions']} solutions ({dt:.1f}s)", flush=True)

    print("\n| rung | recovered | median best CA-RMSD (A) | solutions |")
    print("|---|---|---|---|")
    for name, rec, n, med, nsol, _dt in rows:
        print(f"| {name} | {rec}/{n} | {med:.2f} | {nsol} |")


if __name__ == "__main__":
    main()
