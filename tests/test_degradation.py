"""Mid-ladder degradation regression (round-4 verdict item 3).

The full ladder (SNR sweep to failure, B-factor ramp, anisotropic smear)
runs on the GPU via scripts/degradation_ladder.py and is tabulated in
PARITY.md. This test pins the mid-ladder point — 10 % white noise over a
5 % background plateau, isovalue-clamped — as a regression: docking at
the reference's noisy-system knobs (run_MaD.py:43-47) must still recover
every copy.
"""

import numpy as np
import pytest

from mad_tpu.testing import degrade_map, run_degraded

@pytest.mark.slow
def test_mid_ladder_noise_recovers_all_copies():
    res = run_degraded(dict(name="noise_10pct", noise_sigma=0.10,
                            background=0.05))
    assert res["recovered"] == res["n_copies"], res
    good = [r for r in res["rmsds"] if r < 5.0]
    assert np.median(good) < 2.5, res


def test_degrade_map_statistics():
    """Unit check (fast math, no docking): clamp zeroes the floor, max is
    renormalized, blur removes detail."""
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.testing import make_protein

    sub = make_protein(n_res=60, seed=3)
    clean = simulate_density(sub.coords, 8.0, 2.0, masses=sub.masses)
    g = degrade_map(clean, noise_sigma=0.10, background=0.05, seed=1)
    h = np.asarray(g.host())
    assert h.max() == pytest.approx(1.0, abs=1e-5)
    assert (h == 0).mean() > 0.3          # floor cleared by the clamp
    gb = degrade_map(clean, blur_vox=3.0)
    hb = np.asarray(gb.host())
    assert (hb > 0.5).sum() > (np.asarray(clean.host()) > 0.5).sum()
