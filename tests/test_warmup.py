"""Manifest-replay warmup: record -> replay -> executable reuse.

Cold starts are compile/cache-load bound; replay()
must not only compile the recorded inventory concurrently but also hand
those executables to the first real calls (jit's dispatch cache does not
share lower().compile() results).
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from mad_tpu.utils import warmup


@pytest.fixture()
def isolated_manifest(tmp_path, monkeypatch):
    monkeypatch.setenv("MAD_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(warmup, "_manifest_mem", None)
    monkeypatch.setattr(warmup, "_exe_cache", {})
    return tmp_path


def _pack_overlap_args():
    rng = np.random.default_rng(0)
    dens = jnp.asarray(rng.random((8, 4, 4, 4)).astype(np.float32))
    offs = jnp.zeros((8, 3), jnp.int32)
    return dens, offs


def test_record_replay_exe_reuse(isolated_manifest):
    from mad_tpu.engine.assemble import _compiled_pack_overlap
    _compiled_pack_overlap.cache_clear()

    fn = _compiled_pack_overlap(8, (4, 4, 4), (8, 8), 1)
    assert isinstance(fn, warmup._WarmProxy)
    dens, offs = _pack_overlap_args()
    ref = np.asarray(fn(dens, offs))

    # first call recorded a manifest entry
    man = json.load(open(warmup._manifest_path()))
    assert len(man) == 1

    # replay compiles it into the executable cache
    warmup._exe_cache.clear()
    futs = warmup.replay(block=True)
    assert futs and len(warmup._exe_cache) == 1

    # a fresh matching call is served by the replayed executable: sabotage
    # the dispatch path; only the exe path can produce the result
    fn2 = _compiled_pack_overlap(8, (4, 4, 4), (8, 8), 1)
    orig = fn2._fn
    try:
        fn2._fn = None
        out = np.asarray(fn2(dens, offs))
    finally:
        fn2._fn = orig
    np.testing.assert_allclose(out, ref)


def test_masked_signature_ignores_scalar_values():
    sig = [["arr", [4, 4], "float32"], ["np", "int32", 7.0], ["py", 3]]
    m = warmup._masked(sig)
    assert m == [["arr", [4, 4], "float32"], ["np", "int32"], ["py", "int"]]
    # the same program serves every scalar value
    sig2 = [["arr", [4, 4], "float32"], ["np", "int32", 99.0], ["py", 5]]
    assert warmup._masked(sig2) == m


def test_eviction_is_per_platform(isolated_manifest, monkeypatch):
    monkeypatch.setattr(warmup, "_MANIFEST_MAX", 3)
    for i in range(5):
        warmup._record("m:f", (i,), {}, [["py", 1]], "cpu")
    warmup._record("m:f", (99,), {}, [["py", 1]], "gpu")
    for i in range(5, 9):
        warmup._record("m:f", (i,), {}, [["py", 1]], "cpu")
    man = json.load(open(warmup._manifest_path()))
    plats = [json.loads(k)[0] for k in man]
    assert plats.count("cpu") == 3          # capped
    assert plats.count("gpu") == 1          # survived cpu churn


def test_exe_fallback_on_stale_entry(isolated_manifest):
    """A poisoned executable entry falls back to the dispatch path."""
    from mad_tpu.engine.assemble import _compiled_pack_overlap
    _compiled_pack_overlap.cache_clear()
    fn = _compiled_pack_overlap(8, (4, 4, 4), (8, 8), 1)
    dens, offs = _pack_overlap_args()
    ref = np.asarray(fn(dens, offs))

    class Boom:
        def __call__(self, *a):
            raise RuntimeError("stale")

    key = warmup._exe_key(fn._platform, fn._qual, fn._args, fn._kwargs,
                          warmup._masked(warmup._sig_of((dens, offs))))
    warmup._exe_cache[key] = Boom()
    out = np.asarray(fn(dens, offs))
    np.testing.assert_allclose(out, ref)
    assert key not in warmup._exe_cache     # dropped after the failure


def test_replay_only_filter(isolated_manifest):
    """replay(only=...) restricts the warm to matching program names —
    the staged warm that keeps the map-build chain from queueing behind
    the full inventory on serializing compile services."""
    from mad_tpu.engine.assemble import _compiled_pack_overlap
    _compiled_pack_overlap.cache_clear()
    fn = _compiled_pack_overlap(8, (4, 4, 4), (8, 8), 1)
    dens, offs = _pack_overlap_args()
    np.asarray(fn(dens, offs))          # record

    warmup._exe_cache.clear()
    futs = warmup.replay(block=True, only=("nonexistent_stage",))
    assert futs == [] or len(warmup._exe_cache) == 0
    futs = warmup.replay(block=True, only=("assemble",))
    assert len(warmup._exe_cache) == 1


def test_pipeline_programs_fused_inventory():
    """Shapes under the fused-octave gate prewarm exactly one chain
    program per octave (the split trio otherwise)."""
    from mad_tpu.core.config import MadConfig
    cfg = MadConfig()
    names = [getattr(fn, "_qual", "?").rsplit(":", 1)[-1]
             for fn, _a in warmup.pipeline_programs((96, 96, 96), cfg)]
    assert names == ["_compiled_octave_chain"] * 2


def test_mesh_variant_record_and_replay(isolated_manifest):
    """Mesh static args encode as reconstructible tokens, so mesh program
    variants enter the manifest and replay() compiles them for the right
    device mesh + input shardings (round-4 verdict item 7)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mad_tpu.ops.scalespace import _compiled_log
    _compiled_log.cache_clear()

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("x",))
    dims = (32, 32, 32)
    fn = _compiled_log(dims, 2.0, 1.0, False, 4.0, mesh=mesh)
    assert isinstance(fn, warmup._WarmProxy), \
        "mesh factories must return a recording proxy now"

    rng = np.random.default_rng(0)
    vol = jax.device_put(rng.random(dims).astype(np.float32),
                         NamedSharding(mesh, P("x", None, None)))
    ref = np.asarray(fn(vol))

    man = json.load(open(warmup._manifest_path()))
    assert len(man) == 1
    key = next(iter(man))
    assert "__mesh__" in key and '"x"' in key
    # the sharded input's NamedSharding rode along in the signature
    plat, qual, fargs, fkw, sig = json.loads(key)
    assert sig[0][0] == "arr" and len(sig[0]) == 4

    warmup._exe_cache.clear()
    futs = warmup.replay(block=True)
    assert futs and len(warmup._exe_cache) == 1

    # a fresh matching call is served by the replayed executable
    fn2 = _compiled_log(dims, 2.0, 1.0, False, 4.0, mesh=mesh)
    orig = fn2._fn
    try:
        fn2._fn = None
        out = np.asarray(fn2(vol))
    finally:
        fn2._fn = orig
    np.testing.assert_allclose(out, ref)


def test_mesh_entries_survive_small_process(isolated_manifest, monkeypatch):
    """A manifest entry recorded on an 8-device mesh is SKIPPED (not
    dropped) when replayed with too few devices."""
    import jax

    from mad_tpu.ops.scalespace import _compiled_log
    from jax.sharding import Mesh
    _compiled_log.cache_clear()

    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    fn = _compiled_log((32, 32, 32), 2.0, 1.0, False, 4.0, mesh=mesh)
    fn(jnp.zeros((32, 32, 32), jnp.float32))
    assert len(json.load(open(warmup._manifest_path()))) == 1

    # pretend this process only has one device
    real = jax.devices()
    monkeypatch.setattr(warmup.jax, "devices", lambda: real[:1])
    warmup._exe_cache.clear()
    warmup.replay(block=True)
    assert len(warmup._exe_cache) == 0
    assert len(json.load(open(warmup._manifest_path()))) == 1


def test_manifest_eviction_buckets_by_mesh(isolated_manifest, monkeypatch):
    """Mesh-variant entries evict within their own (platform, mesh shape)
    bucket and never push out the single-device inventory."""
    monkeypatch.setattr(warmup, "_MANIFEST_MAX", 2)
    warmup._record("m:f", (1,), {}, [["py", 1]], "cpu")
    warmup._record("m:g", (2,), {}, [["py", 1]], "cpu")
    for i in range(4):
        warmup._record(f"m:mesh{i}",
                       (("__mesh__", ("x",), (8,)), i), {},
                       [["py", 1]], "cpu")
    man = json.load(open(warmup._manifest_path()))
    quals = {json.loads(k)[1] for k in man}
    assert {"m:f", "m:g"} <= quals            # single-device kept
    assert sum(1 for q in quals if q.startswith("m:mesh")) == 2
