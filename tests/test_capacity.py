"""Capacity mode: sharded-gather kernels equal their single-device runs.

VERDICT r2 item 2: a mesh must EXTEND map capacity, not just throughput —
the LoG/gradient volumes stay x-slab-sharded through detect / orient /
describe (halo-extended local gathers), so a map one chip cannot hold
spreads over the mesh. These tests pin per-kernel equality on a virtual
CPU mesh and assert the sharding is real (no device holds a full field).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mad_tpu.core.config import DetectConfig, OrientConfig, DescribeConfig
from mad_tpu.parallel.mesh import make_mesh, mesh_axis

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device CPU mesh")


def _shard_vol(vol, mesh):
    ax = mesh_axis(mesh)
    spec = P(ax, *([None] * (vol.ndim - 1)))
    return jax.device_put(vol, NamedSharding(mesh, spec))


def _assert_sharded(arr, mesh):
    """No addressable shard holds the full dim-0 extent."""
    n = np.prod([mesh.shape[a] for a in mesh.axis_names])
    shard_rows = {s.data.shape[0] for s in arr.addressable_shards}
    assert shard_rows == {arr.shape[0] // n}


@needs_devices
def test_halo_extend_matches_pad():
    from mad_tpu.parallel.volume import halo_extend
    from jax import shard_map

    rng = np.random.default_rng(0)
    mesh = make_mesh(4)
    for halo, shape in ((3, (32, 6, 5)), (11, (32, 6, 5)),
                        (4, (32, 6, 5, 3))):
        vol = jnp.asarray(rng.random(shape), jnp.float32)
        spec = P("x", *([None] * (vol.ndim - 1)))
        fn = shard_map(lambda b: halo_extend(b, halo, "x", 4), mesh=mesh,
                       in_specs=(spec,), out_specs=spec)
        got = np.asarray(fn(_shard_vol(vol, mesh)))
        blk = shape[0] // 4
        ref = np.pad(np.asarray(vol),
                     [(halo, halo)] + [(0, 0)] * (vol.ndim - 1))
        for s in range(4):
            np.testing.assert_array_equal(
                got[s * (blk + 2 * halo):(s + 1) * (blk + 2 * halo)],
                ref[s * blk:s * blk + blk + 2 * halo])


@pytest.fixture(scope="module")
def log_vol():
    # smooth blobby volume with distinct peaks (no response ties)
    rng = np.random.default_rng(1)
    from scipy.ndimage import gaussian_filter
    v = gaussian_filter(rng.random((64, 48, 48)), 2.5).astype(np.float32)
    v = np.maximum(v - v.mean(), 0.0) * 10.0
    return jnp.asarray(v)


@needs_devices
def test_detect_sharded_equals_single(log_vol):
    from mad_tpu.ops.detect import detect_anchors

    cfg = DetectConfig(max_anchors=256, threshold_abs=1e-3)
    real = tuple(log_vol.shape)
    a1 = detect_anchors(log_vol, real, cfg)
    mesh = make_mesh(8)
    a8 = detect_anchors(_shard_vol(log_vol, mesh), real, cfg, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(a8.valid), np.asarray(a1.valid))
    np.testing.assert_array_equal(np.asarray(a8.coords),
                                  np.asarray(a1.coords))
    np.testing.assert_allclose(np.asarray(a8.subvox), np.asarray(a1.subvox),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(a8.values), np.asarray(a1.values),
                               atol=1e-6)
    assert int(np.sum(np.asarray(a1.valid))) > 5


@pytest.fixture(scope="module")
def grad_field(log_vol):
    g = jnp.stack(jnp.gradient(log_vol), axis=-1)
    return g


@needs_devices
def test_orient_describe_sharded_equal_single(log_vol, grad_field):
    from mad_tpu.ops.detect import detect_anchors
    from mad_tpu.ops.orient import orient_anchors
    from mad_tpu.ops.describe import describe_anchors

    dcfg = DetectConfig(max_anchors=256, threshold_abs=1e-3)
    ocfg = OrientConfig()
    real = tuple(log_vol.shape)
    anch = detect_anchors(log_vol, real, dcfg)
    o1 = orient_anchors(grad_field, anch, real, False, ocfg)
    n1 = int(np.sum(np.asarray(o1.valid)))
    assert n1 > 0

    mesh = make_mesh(4)
    gsh = _shard_vol(grad_field, mesh)
    _assert_sharded(gsh, mesh)
    o4 = orient_anchors(gsh, anch, real, False, ocfg, mesh=mesh,
                        shard_k=256)
    # reassemble the mesh lanes into anchor-slot space and compare
    K, M, S = o1.valid.shape
    got_valid = np.zeros((K, M, S), bool)
    got_main = np.zeros((K, M), np.int32)
    got_sec = np.zeros((K, M, S), np.int32)
    got_rfin = np.zeros((K, M, S, 3, 3), np.float32)
    idx = np.asarray(o4.anchor_idx)
    v4 = np.asarray(o4.valid)
    for row in range(v4.shape[0]):
        slot = idx[row]
        if not v4[row].any():
            continue
        got_valid[slot] = v4[row]
        got_main[slot] = np.asarray(o4.main_bin)[row]
        got_sec[slot] = np.asarray(o4.sec_bin)[row]
        got_rfin[slot] = np.asarray(o4.rfinal)[row]
    ref_valid = np.asarray(o1.valid)
    np.testing.assert_array_equal(got_valid, ref_valid)
    np.testing.assert_array_equal(got_main[ref_valid.any(axis=-1)],
                                  np.asarray(o1.main_bin)[
                                      ref_valid.any(axis=-1)])
    np.testing.assert_array_equal(got_sec[ref_valid],
                                  np.asarray(o1.sec_bin)[ref_valid])
    np.testing.assert_allclose(got_rfin[ref_valid],
                               np.asarray(o1.rfinal)[ref_valid], atol=1e-6)

    # describe: single-device lanes vs capacity-mode per-shard selection
    flat_ok = np.asarray(o1.valid).reshape(-1)
    lanes = np.nonzero(flat_ok)[0]
    cap = max(128, ((len(lanes) + 127) // 128) * 128)
    lane_idx = np.concatenate([lanes, np.zeros(cap - len(lanes), np.int64)])
    coords = np.asarray(anch.coords)[lane_idx // (M * S)]
    rfin = np.asarray(o1.rfinal).reshape(-1, 3, 3)[lane_idx]
    ok_in = flat_ok[lane_idx]
    ok_in[len(lanes):] = False
    ccfg = DescribeConfig()
    d1, k1 = describe_anchors(grad_field, jnp.asarray(coords),
                              jnp.asarray(rfin), jnp.asarray(ok_in), real,
                              False, ccfg)
    d4, k4, ord4, _cnt = describe_anchors(
        gsh, jnp.asarray(coords), jnp.asarray(rfin), jnp.asarray(ok_in),
        real, False, ccfg, mesh=mesh, shard_l=cap)
    d1h, k1h = np.asarray(d1), np.asarray(k1)
    d4h, k4h, o4h = np.asarray(d4), np.asarray(k4), np.asarray(ord4)
    # every ok input lane appears exactly once in the mesh output, equal
    seen = {}
    for r in range(len(o4h)):
        if k4h[r]:
            assert o4h[r] not in seen
            seen[o4h[r]] = r
    assert set(seen) == set(np.nonzero(k1h)[0])
    for lane, row in seen.items():
        np.testing.assert_array_equal(d4h[row], d1h[lane])


@needs_devices
@pytest.mark.slow
def test_describe_grid_capacity_no_full_gradient(monkeypatch):
    """Full capacity-mode describe chain equals single-device AND the
    gradient programs only ever produce sharded fields (watched via
    LazyOctave.grad)."""
    from mad_tpu.core.config import MadConfig
    import dataclasses

    from mad_tpu.engine.pipeline import describe_grid
    from mad_tpu.ops import scalespace
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.testing import make_assembly

    cfg = MadConfig()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses,
                            shape_bucket=cfg.shape_bucket)

    mesh = make_mesh(8)
    n = 8
    grads_seen = []
    orig_grad = scalespace.LazyOctave.grad

    def spy(self):
        g = orig_grad(self)
        grads_seen.append(g)
        return g

    monkeypatch.setattr(scalespace.LazyOctave, "grad", spy)
    d1 = describe_grid(dmap, cfg, name="m")
    n_single = len(grads_seen)
    grads_seen.clear()
    d8 = describe_grid(dmap, cfg, name="m", mesh=mesh)
    assert len(grads_seen) >= n_single
    for g in grads_seen[n_single - 2:] if n_single else grads_seen:
        pass
    # the mesh run's gradient fields are genuinely sharded
    for g in grads_seen:
        shard_rows = {s.data.shape[0] for s in g.addressable_shards}
        assert shard_rows == {g.shape[0] // n}, (g.shape, shard_rows)

    assert d1.n == d8.n > 0
    np.testing.assert_array_equal(np.asarray(d1.desc), np.asarray(d8.desc))
    np.testing.assert_allclose(d1.subv_coords, d8.subv_coords, atol=1e-6)
    np.testing.assert_allclose(d1.rfinal, d8.rfinal, atol=1e-6)
    np.testing.assert_array_equal(d1.main_bin, d8.main_bin)
    np.testing.assert_array_equal(d1.sec_bin, d8.sec_bin)
    np.testing.assert_array_equal(d1.anchor_id, d8.anchor_id)
    np.testing.assert_array_equal(d1.octave, d8.octave)
