import os

import numpy as np
import pytest

from mad_tpu.core import metrics
from mad_tpu.core.eqsp import get_eqsp
from mad_tpu.core.eqsp_viz import write_eqsp_tcl, write_def_pdb, occupancy_ascii
from mad_tpu.core.grid import DensityGrid, ccc_maps_scaled


def test_bc_scoring_perfect_classifier():
    y = np.array([0, 0, 1, 1, 1])
    p = np.array([0.1, 0.2, 0.9, 0.8, 0.7])
    s = metrics.bc_scoring(y, p)
    assert s["acc"] > 0.99
    assert s["mcc"] > 0.99
    assert s["auc"] == pytest.approx(1.0)


def test_mcc_precision_f1_sweeps():
    y = np.array([0, 1, 0, 1, 1, 0])
    p = np.array([0.2, 0.8, 0.4, 0.9, 0.6, 0.1])
    mcc, data = metrics.mcc_scoring(y, p)
    assert len(mcc) == 21
    assert data[4] > 0.9           # best MCC found
    prec, _ = metrics.precision_scoring(y, p)
    assert max(prec) > 0.9
    f1 = metrics.f1_scoring(y, p)
    assert max(f1) > 0.9


def test_eqsp_viz(tmp_path):
    tcl = str(tmp_path / "eqsp.tcl")
    write_eqsp_tcl(tcl, size=16)
    content = open(tcl).read()
    assert content.count("draw sphere") == 16
    assert "draw cylinder" in content
    write_def_pdb(str(tmp_path / "def.pdb"))
    assert open(str(tmp_path / "def.pdb")).read().startswith("ATOM")


def test_occupancy_ascii():
    eqsp = get_eqsp(16)
    counts = np.arange(16)
    text = occupancy_ascii(counts, eqsp)
    assert len(text.splitlines()) == 4  # cap, belt, belt, cap


def test_mask_with():
    a = DensityGrid(data=np.ones((6, 6, 6), np.float32),
                    origin=np.zeros(3), voxsp=1.0)
    mdat = np.zeros((6, 6, 6), np.float32)
    mdat[2:4] = 1.0
    m = DensityGrid(data=mdat, origin=np.zeros(3), voxsp=1.0)
    out = a.mask_with(m)
    assert out.data[3, 0, 0] == 1.0 and out.data[0, 0, 0] == 0.0
    assert out.data.sum() == mdat.sum()


def test_ccc_maps_scaled_identical():
    rng = np.random.default_rng(0)
    d = rng.random((8, 8, 8)).astype(np.float32)
    g = DensityGrid(data=d, origin=np.zeros(3), voxsp=1.0)
    assert ccc_maps_scaled(g, g) == pytest.approx(1.0, abs=1e-5)


def test_compat_records():
    from mad_tpu.compat import to_records
    from mad_tpu.engine.pipeline import DescriptorSet
    n = 3
    ds = DescriptorSet(
        desc=np.ones((n, 1024), np.int16),
        desc_norm=np.ones((n, 1024), np.float32) / 32.0,
        coords=np.zeros((n, 3), np.float32), map_coords=np.zeros((n, 3)),
        subv_coords=np.zeros((n, 3)),
        rfinal=np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)),
        octave=np.zeros(n, np.int32), anchor_id=np.arange(n, dtype=np.int32),
        main_bin=np.zeros(n, np.int32), sec_bin=np.ones(n, np.int32))
    recs = to_records(ds)
    assert len(recs) == 3
    assert recs[1].index == 1 and recs[1].sec_bin == 1
    assert "DF @o=0" in recs[0].show()


def test_compat_anchor_dump_roundtrip(tmp_path):
    from mad_tpu.compat import write_anchors, load_anchors
    from mad_tpu.engine.pipeline import DescriptorSet
    n = 4
    rng = np.random.default_rng(3)
    ds = DescriptorSet(
        desc=np.ones((n, 1024), np.int16),
        desc_norm=np.ones((n, 1024), np.float32) / 32.0,
        coords=rng.random((n, 3)).astype(np.float32),
        map_coords=rng.random((n, 3)), subv_coords=rng.random((n, 3)),
        rfinal=np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)),
        octave=np.zeros(n, np.int32), anchor_id=np.arange(n, dtype=np.int32),
        main_bin=np.arange(n, dtype=np.int32),
        sec_bin=np.ones(n, np.int32))
    out = str(tmp_path / "anchors")
    write_anchors(ds, out, save_regular=True)
    rec = load_anchors(out + "_data.npy")
    assert len(rec) == n
    np.testing.assert_allclose(rec["subv_map_coords"], ds.subv_coords)
    np.testing.assert_array_equal(rec["main_bin"], ds.main_bin)
    with open(out + ".pdb") as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 2 * n            # chain A (subv) + chain B (grid)


def test_config_survives_run_kwargs():
    """run() rebuilds the config from kwargs but keeps construction-time
    knobs the kwarg surface does not cover (ADVICE r2)."""
    import dataclasses
    from mad_tpu.core.config import MadConfig
    base = MadConfig(warm_start=False)
    base = base.replace(filter=dataclasses.replace(base.filter,
                                                   rescue_rounds=2))
    cfg = MadConfig.from_run_kwargs(n_samples=99, base=base)
    assert cfg.warm_start is False
    assert cfg.filter.rescue_rounds == 2
    assert cfg.filter.n_samples == 99
    # default remains reference parity: no rescue rounds
    assert MadConfig().filter.rescue_rounds == 0


def test_describe_many_memory_guard():
    """Concurrent describe chains serialize when the combined working
    volumes would not fit device memory side by side."""
    import threading
    from mad_tpu.engine.pipeline import describe_many

    active = []
    peak = []
    lock = threading.Lock()

    def job():
        import time
        with lock:
            active.append(1)
            peak.append(len(active))
        time.sleep(0.02)
        with lock:
            active.pop()
        return "ok"

    out = describe_many([job, job], voxels=[200_000_000, 200_000_000])
    assert out == ["ok", "ok"] and max(peak) == 1     # serialized
    peak.clear()
    out = describe_many([job, job], voxels=[1_000, 1_000])
    assert out == ["ok", "ok"]                        # threaded path runs


def test_matching_cache_roundtrip(tmp_path):
    from mad_tpu import cache
    from mad_tpu.engine.match import MatchTable
    rng = np.random.default_rng(1)
    t = MatchTable(
        cc=rng.random(5), repeat=rng.random(5) * 100,
        hi_idx=np.arange(5), lo_idx=np.arange(5)[::-1].copy(),
        rot=np.broadcast_to(np.eye(3), (5, 3, 3)).copy(),
        hi_coord=rng.random((5, 3)), lo_coord=rng.random((5, 3)),
        hi_cloud=rng.random((7, 3)), lo_cloud=rng.random((9, 3)))
    path = str(tmp_path / "m.h5")
    cache.save_matching(t, path)
    t2 = cache.load_matching(path)
    np.testing.assert_allclose(t2.cc, t.cc)
    np.testing.assert_allclose(t2.rot, t.rot)
    np.testing.assert_allclose(t2.hi_cloud, t.hi_cloud)
    np.testing.assert_array_equal(t2.lo_idx, t.lo_idx)


def test_functional_repeatability():
    from mad_tpu.functional import get_repeatability
    from mad_tpu.engine.pipeline import DescriptorSet

    def mkset(coords):
        n = len(coords)
        return DescriptorSet(
            desc=np.ones((n, 16), np.int16),
            desc_norm=np.ones((n, 16), np.float32),
            coords=np.zeros((n, 3), np.float32),
            map_coords=np.asarray(coords, float),
            subv_coords=np.asarray(coords, float),
            rfinal=np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)),
            octave=np.zeros(n, np.int32),
            anchor_id=np.arange(n, dtype=np.int32),
            main_bin=np.zeros(n, np.int32), sec_bin=np.zeros(n, np.int32))

    a = mkset([[0, 0, 0], [10, 0, 0], [20, 0, 0]])
    b = mkset([[1, 0, 0], [10.5, 0, 0], [100, 0, 0]])
    rep = get_repeatability(a, b, radii=(2.0,))
    assert rep[2.0] == pytest.approx(100.0 * 2 / 3)


@pytest.mark.slow
def test_stage_sanitizer_localizes_nan(monkeypatch):
    """MAD_TPU_NANCHECK=1 (stage mode): a seeded NaN is localized to its
    pipeline stage with NO recompiles (jax_debug_nans stays off), via
    isfinite reductions folded into the consolidated pulls (SURVEY §5)."""
    import jax
    from mad_tpu.core.config import MadConfig
    from mad_tpu.core.grid import DensityGrid
    from mad_tpu.engine.pipeline import describe_grid
    from mad_tpu.utils import sanitize

    monkeypatch.setenv("MAD_TPU_NANCHECK", "1")
    assert sanitize.mode() == "stage"
    assert not jax.config.jax_debug_nans          # no global recompile mode
    rng = np.random.default_rng(0)
    data = rng.random((48, 48, 48)).astype(np.float32)
    data[20, 20, 20] = np.nan
    grid = DensityGrid(data=data, origin=np.zeros(3), voxsp=2.0)
    sanitize.clear()
    try:
        # the fused LoG+detect program surfaces the NaN at the detect
        # stage; the gradient programs flag it independently
        with pytest.raises(FloatingPointError,
                           match=r"detect\[o0\].*scalespace\.grad"):
            describe_grid(grid, MadConfig(), name="bad")
    finally:
        sanitize.clear()

    # clean inputs pass through the same checks silently
    good = DensityGrid(data=rng.random((48, 48, 48)).astype(np.float32),
                       origin=np.zeros(3), voxsp=2.0)
    describe_grid(good, MadConfig(), name="good")
    sanitize.flush()


def test_check_host_fires(monkeypatch):
    from mad_tpu.utils import sanitize
    monkeypatch.setenv("MAD_TPU_NANCHECK", "1")
    sanitize.check_host("ok.stage", np.ones(3))          # silent
    with pytest.raises(FloatingPointError, match="bad.stage"):
        sanitize.check_host("bad.stage", np.array([1.0, np.nan]))
    monkeypatch.setenv("MAD_TPU_NANCHECK", "0")
    sanitize.check_host("off.stage", np.array([np.nan]))  # disabled


def test_nan_check_mode():
    """Opt-in sanitizer (SURVEY section 5): jitted stages raise at the
    producing primitive instead of propagating NaN silently."""
    import jax
    import jax.numpy as jnp
    from mad_tpu.core.config import set_nan_checks

    @jax.jit
    def bad(x):
        return jnp.log(x - 1.0)    # NaN for x < 1

    set_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(bad(jnp.float32(0.5)))
    finally:
        set_nan_checks(False)
    # disabled again: NaN propagates silently (default pipeline behavior)
    assert np.isnan(np.asarray(bad(jnp.float32(0.5))))


def test_hbm_audit_mode(monkeypatch):
    """MAD_TPU_HBM=1 samples per-stage device allocation high-water marks
    (SURVEY §5 donation/memory audit); CPU backends without memory_stats
    degrade to zero samples without crashing."""
    import importlib
    from mad_tpu.utils import profiling
    monkeypatch.setenv("MAD_TPU_HBM", "1")
    with profiling.stage("hbm_test_stage"):
        pass
    peaks = profiling.hbm_peaks()
    assert isinstance(peaks, dict)
    b = profiling.device_bytes_in_use()
    assert isinstance(b, int) and b >= 0
    profiling.show_timing(reset=True)
