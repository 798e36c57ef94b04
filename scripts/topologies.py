"""Run the symmetric/helical topology matrix and print the PARITY table.

Each row of mad_tpu.testing.TOPOLOGY_REGIMES mirrors one of the
reference's flagship symmetric systems (VAT C6, GroEL D7, actin-like
helical filament); see tests/test_topologies.py for the committed
assertions. This script prints the markdown rows recorded in PARITY.md §7.
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

from mad_tpu.testing import TOPOLOGY_REGIMES, run_topology


def main():
    rows = []
    for regime in TOPOLOGY_REGIMES:
        t0 = time.time()
        res = run_topology(regime)
        dt = time.time() - t0
        good = [r for r in res["rmsds"] if r < res["threshold"]]
        med = float(np.median(good)) if good else float("nan")
        rows.append((res, med, dt))
        print(f"topo> {res['name']}: {res['recovered']}/{res['n_copies']} "
              f"recovered, {res['distinct_claimed']} distinct solutions "
              f"claimed, median RMSD {med:.2f} A, "
              f"{res['n_solutions']} solutions ({dt:.1f}s)", flush=True)

    print("\n| topology | copies | recovered | distinct sols claimed | "
          "median best CA-RMSD (A) | map |")
    print("|---|---|---|---|---|---|")
    for res, med, _dt in rows:
        print(f"| {res['name']} ({res['cite'].split('(')[0].strip()}) | "
              f"{res['n_copies']} | {res['recovered']}/{res['n_copies']} | "
              f"{res['distinct_claimed']} | {med:.2f} | "
              f"{'x'.join(map(str, res['map_shape']))} |")


if __name__ == "__main__":
    main()
