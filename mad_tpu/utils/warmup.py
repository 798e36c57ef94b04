"""Concurrent ahead-of-time compilation of the describe-side programs.

Cold start is compile-bound, not compute-bound: the first run of the
pipeline triggers one XLA compile per (program, shape). The describe-side
programs' shapes are fully determined by (grid shape, config), so they can
be lowered up front and compiled on a thread pool — overlapping the
compiles instead of paying them serially at first use.

Shapes that depend on data (matched-pair counts, candidate counts) cannot
be precompiled exactly and are left to first use; the describe side
dominates the compile inventory (2 octaves x {log, grad, detect, orient,
describe} per distinct grid bucket).
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import json
import os
import threading
from typing import Iterable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.config import MadConfig, bucket

# ---------------------------------------------------------------------------
# Manifest-replay warmup: every @warmable compiled-program factory records
# (factory, static args, first-call signature, backend platform) into a
# manifest next to the persistent XLA cache. ``replay()`` re-lowers and
# compiles the whole recorded inventory on a thread pool at process start,
# so recurring shapes — including data-dependent ones no predictive warm
# can know — pay their compile/cache-load round-trips concurrently instead
# of serially at first use.
#
# The compiled executables replay produces are kept in an in-process cache
# keyed by (platform, factory, static args, value-masked call signature);
# the @warmable proxy calls them DIRECTLY when a call's signature matches.
# Without this, the first real call of each program re-lowers and pays a
# fresh compile (or cache load) even though replay already compiled the
# identical program (jit's dispatch cache does not share lower().compile()
# results).
# ---------------------------------------------------------------------------

_MANIFEST_MAX = 192        # per backend platform (cpu test runs must not
                           # evict the accelerator bench inventory)
_manifest_lock = threading.Lock()
_manifest_mem: Optional[dict] = None

_exe_cache: dict = {}      # masked key -> compiled executable (GIL-atomic)
_exe_futures: dict = {}    # masked key -> in-flight compile Future: a first
                           # use that would MISS waits for the replay/warm
                           # compile of the same program instead of racing
                           # it with a duplicate lower + compile


def _manifest_path() -> str:
    from ..core.config import cache_root
    return os.path.join(cache_root(), "warm_manifest.json")


def _load_manifest() -> dict:
    global _manifest_mem
    if _manifest_mem is None:
        if os.environ.get("MAD_TPU_MANIFEST_RESET", "") not in ("", "0"):
            # Start from an empty inventory: the file is rewritten with
            # exactly the programs THIS process records. Run a steady-state
            # workload under this flag to prune stale entries (old frame
            # rungs, removed programs) that would otherwise burn replay
            # pool slots every process start.
            _manifest_mem = {}
            return _manifest_mem
        try:
            with open(_manifest_path()) as f:
                _manifest_mem = json.load(f)
        except (OSError, ValueError):
            _manifest_mem = {}
    return _manifest_mem


def _flush_manifest(man: dict) -> None:
    path = _manifest_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _jsonable(x) -> bool:
    if isinstance(x, (int, float, bool, str)) or x is None:
        return True
    if isinstance(x, (tuple, list)):
        return all(_jsonable(v) for v in x)
    return False


# ---------------------------------------------------------------------------
# Mesh-variant warm (round-4 verdict item 7). A jax.sharding.Mesh static
# argument is not JSON-able, so mesh program variants never entered the
# manifest and MaD(mesh=...) paid serial first-use compiles. Meshes are
# structurally determined here by (axis names, device-grid shape) — every
# caller builds them over jax.devices() in order (parallel/mesh.auto_mesh)
# — so a mesh encodes as the token ("__mesh__", axis_names, grid_shape)
# and reconstructs at replay time from the current process's devices. A
# process with fewer devices skips (NOT drops) those entries: the 8-chip
# inventory must survive single-chip sessions.
# ---------------------------------------------------------------------------

class _MeshUnavailable(Exception):
    pass


def _encode_static(args):
    """Static factory args with Mesh values replaced by JSON-able tokens;
    None when some value is neither JSON-able nor a Mesh."""
    from jax.sharding import Mesh
    out = []
    for a in args:
        if isinstance(a, Mesh):
            out.append(("__mesh__",
                        tuple(str(n) for n in a.axis_names),
                        tuple(int(s) for s in a.devices.shape)))
        elif _jsonable(a):
            out.append(a)
        else:
            return None
    return tuple(out)


def _decode_static(args):
    """Inverse of _encode_static: rebuild Mesh objects over this process's
    devices (raises _MeshUnavailable when there are too few)."""
    out = []
    for a in args:
        if (isinstance(a, tuple) and len(a) == 3 and a[0] == "__mesh__"):
            out.append(_mesh_from_token(a[1], a[2]))
        else:
            out.append(a)
    return tuple(out)


def _mesh_from_token(axis_names, grid_shape):
    import numpy as np
    from jax.sharding import Mesh
    n = 1
    for s in grid_shape:
        n *= int(s)
    devs = jax.devices()
    if len(devs) < n:
        raise _MeshUnavailable(f"{n} devices needed, {len(devs)} present")
    return Mesh(np.array(devs[:n]).reshape(tuple(int(s) for s in grid_shape)),
                tuple(axis_names))


def _listify(x):
    if isinstance(x, (tuple, list)):
        return [_listify(v) for v in x]
    return x


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def _sharding_token(a):
    """JSON token for a NamedSharding over a reconstructible mesh; None for
    single-device/unspecified shardings (the common case)."""
    try:
        from jax.sharding import NamedSharding
        sh = a.sharding
        if not isinstance(sh, NamedSharding):
            return None
        mesh = sh.mesh
        if getattr(mesh, "size", 1) <= 1:
            return None
        spec = [list(p) if isinstance(p, tuple) else p for p in sh.spec]
        return [[str(n) for n in mesh.axis_names],
                [int(s) for s in mesh.devices.shape], spec]
    except Exception:
        return None


def _sig_of(args) -> Optional[list]:
    """JSON call signature: arrays as [shape, dtype (, sharding token)],
    scalars verbatim. Mesh-sharded arrays carry their NamedSharding so the
    replayed executable is compiled for the layouts the real call uses."""
    import numpy as np
    sig = []
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            entry = ["arr", list(a.shape), str(np.dtype(a.dtype))]
            tok = _sharding_token(a)
            if tok is not None:
                entry.append(tok)
            sig.append(entry)
        elif isinstance(a, (np.integer, np.floating, np.bool_)):
            sig.append(["np", str(np.dtype(type(a))), float(a)])
        elif isinstance(a, (int, float, bool)):
            sig.append(["py", a])
        else:
            return None
    return sig


def _abstract_of(sig):
    import numpy as np
    out = []
    for s in sig:
        if s[0] == "arr":
            kw = {}
            if len(s) > 3:
                from jax.sharding import NamedSharding, PartitionSpec
                axis_names, grid_shape, spec = s[3]
                mesh = _mesh_from_token(axis_names, grid_shape)
                parts = [tuple(p) if isinstance(p, list) else p
                         for p in spec]
                kw["sharding"] = NamedSharding(mesh, PartitionSpec(*parts))
            out.append(jax.ShapeDtypeStruct(tuple(s[1]), np.dtype(s[2]),
                                            **kw))
        elif s[0] == "np":
            out.append(np.dtype(s[1]).type(s[2]))
        else:
            out.append(s[1])
    return out


def _masked(sig) -> list:
    """Call signature with scalar VALUES masked to their dtype: scalars are
    dynamic (traced) inputs, so one compiled executable serves every value
    — the executable-reuse key must not split on them."""
    out = []
    for s in sig:
        if s[0] == "arr":
            out.append(s)
        elif s[0] == "np":
            out.append(["np", s[1]])
        else:
            out.append(["py", type(s[1]).__name__])
    return out


def _exe_key(platform, qual, fargs, fkwargs, masked_sig) -> str:
    return json.dumps([platform, qual, _listify(list(fargs)),
                       {k: _listify(v) for k, v in sorted(fkwargs.items())},
                       masked_sig])


class _WarmProxy:
    """Callable wrapper around a jitted program that records its first call
    signature into the manifest and routes matching calls through the
    executables ``replay()`` already compiled (skipping jit's re-lower +
    compile on first use). Delegates everything else."""

    __slots__ = ("_fn", "_qual", "_args", "_kwargs", "_recorded",
                 "_platform", "__weakref__")

    def __init__(self, fn, qual, args, kwargs):
        self._fn = fn
        self._qual = qual
        self._args = args
        self._kwargs = kwargs
        self._recorded = False
        self._platform = None

    def __call__(self, *a, **kw):
        if not kw and not any(isinstance(x, jax.core.Tracer) for x in a):
            # (tracer args — e.g. jax.eval_shape or an enclosing trace —
            # must go through the ordinary dispatch path: a compiled
            # executable cannot accept tracers, and the TypeError would
            # wrongly evict it as stale)
            sig = _sig_of(a)
            if sig is not None:
                if self._platform is None:
                    try:
                        self._platform = jax.default_backend()
                    except Exception:
                        self._platform = ""
                if not self._recorded:
                    self._recorded = True
                    _record(self._qual, self._args, self._kwargs, sig,
                            self._platform)
                key = _exe_key(self._platform, self._qual, self._args,
                               self._kwargs, _masked(sig))
                exe = _exe_cache.get(key)
                if exe is None:
                    fut = _exe_futures.get(key)
                    if fut is not None:
                        # replay/warm is already compiling this very
                        # program: wait for it rather than re-lowering and
                        # paying a second compile in parallel
                        try:
                            fut.result()
                        except Exception:
                            pass
                        exe = _exe_cache.get(key)
                if exe is not None and jax.config.jax_debug_nans:
                    exe = None      # sanitizer mode needs the dispatch path
                if exe is not None:
                    try:
                        if os.environ.get("MAD_TPU_DEBUG_WARM"):
                            import time as _t
                            t0 = _t.time()
                            out = exe(*a)
                            dt = _t.time() - t0
                            if dt > 1.0:
                                print(f"warm> exe call {self._qual} "
                                      f"{dt:.1f}s", flush=True)
                            return out
                        return exe(*a)
                    except Exception as e:
                        # aval/layout drift: drop the stale executable and
                        # fall through to the ordinary dispatch path
                        _exe_cache.pop(key, None)
                        if os.environ.get("MAD_TPU_DEBUG_WARM"):
                            print(f"warm> STALE exe {self._qual}: "
                                  f"{type(e).__name__}: {e}", flush=True)
                elif os.environ.get("MAD_TPU_DEBUG_WARM"):
                    print(f"warm> exe MISS {self._qual} sig={_masked(sig)}")
        return self._fn(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def _record(qual: str, fargs, fkwargs, sig, platform: str) -> None:
    if not platform:
        return
    key = json.dumps([platform, qual, _listify(list(fargs)),
                      {k: _listify(v) for k, v in sorted(fkwargs.items())},
                      sig])
    with _manifest_lock:
        man = _load_manifest()
        if key in man:
            return
        man[key] = True

        # evict oldest entries of the SAME (platform, mesh shape) bucket
        # only: cpu test runs must never push the gpu bench inventory out,
        # and mesh-variant inventories must not evict single-device ones
        # (nor each other across mesh shapes)
        def bucket_of(k):
            plat, _q, fargs, fkw, _s = json.loads(k)
            mesh = ""
            for v in list(fargs) + list(fkw.values()):
                if (isinstance(v, list) and len(v) == 3
                        and v[0] == "__mesh__"):
                    mesh = json.dumps(v[1:])
            return (plat, mesh)

        me = bucket_of(key)
        mine = [k for k in man if bucket_of(k) == me]
        drop = len(mine) - _MANIFEST_MAX
        for k in mine[:max(0, drop)]:
            man.pop(k)
        _flush_manifest(man)


def warmable(factory):
    """Decorator for compiled-program factories (apply UNDER lru_cache):
    returns a recording proxy when the static args are JSON-able — with
    Mesh arguments encoded as reconstructible tokens (_encode_static) —
    and the raw program otherwise."""
    qual = factory.__module__ + ":" + factory.__name__

    @functools.wraps(factory)
    def wrapper(*args, **kw):
        fn = factory(*args, **kw)
        eargs = _encode_static(args)
        ekw_vals = _encode_static(tuple(kw.values()))
        if eargs is None or ekw_vals is None:
            return fn
        return _WarmProxy(fn, qual, eargs,
                          dict(zip(kw.keys(), ekw_vals)))

    return wrapper


def _track(ekey, fut) -> None:
    """Register an in-flight compile under its key until it finishes. The
    entry leaves through a done-callback, which also runs when the job
    finished before registration, so no finished future lingers and
    makes a later replay skip the program."""
    if _exe_futures.setdefault(ekey, fut) is fut:
        fut.add_done_callback(
            lambda f: _exe_futures.pop(ekey, None)
            if _exe_futures.get(ekey) is f else None)


def replay(max_workers: int = 8, block: bool = False, only=None):
    """AOT-compile every manifest entry recorded for the current backend on
    a thread pool. Stale entries (changed factory signatures) are dropped.
    Returns the futures; with block=True waits and ignores failures.
    Disabled by MAD_TPU_NO_WARM=1 (diagnostics / constrained hosts).

    only: optional substrings — replay just the programs whose qualified
    name matches one (stage the warm: the map-build chain first, alone,
    then everything else; whatever the main thread needs FIRST should not
    queue behind 30 dummy compiles)."""
    import importlib

    if os.environ.get("MAD_TPU_NO_WARM", "") not in ("", "0"):
        return []
    try:
        platform = jax.default_backend()
    except Exception:
        return []
    with _manifest_lock:
        man = dict(_load_manifest())
    jobs = []
    stale = []
    seen = set()
    for key in man:
        try:
            plat, qual, fargs, fkwargs, sig = json.loads(key)
            if plat != platform:
                continue
            if only is not None and not any(s in qual for s in only):
                continue
            ekey = _exe_key(plat, qual, _tuplify(fargs),
                            {k: _tuplify(v) for k, v in fkwargs.items()},
                            _masked(sig))
            if ekey in seen or ekey in _exe_cache or ekey in _exe_futures:
                continue
            seen.add(ekey)
            mod_name, fn_name = qual.split(":")
            mod = importlib.import_module(mod_name)
            factory = getattr(mod, fn_name)
            fn = factory(*_decode_static(_tuplify(fargs)),
                         **dict(zip(fkwargs.keys(),
                                    _decode_static(tuple(
                                        _tuplify(v)
                                        for v in fkwargs.values())))))
            if isinstance(fn, _WarmProxy):
                fn = fn._fn
            jobs.append((fn, _abstract_of(sig), ekey))
        except _MeshUnavailable:
            # mesh entry recorded by a bigger process: keep it for when
            # enough devices are present again, just skip it now
            continue
        except Exception:
            stale.append(key)
    if stale:
        with _manifest_lock:
            live = _load_manifest()
            for key in stale:
                live.pop(key, None)
            _flush_manifest(live)

    if not jobs:
        return []
    # compile in pipeline order so the stage that runs first has its
    # executables ready first (replay races the actual run)
    order = ["simulate", "grid", "scalespace", "detect", "orient",
             "describe", "match", "refine", "score", "assemble"]

    def prio(job):
        q = job[2]
        for i, name in enumerate(order):
            if name in q:
                return i
        return len(order)

    jobs.sort(key=prio)
    pool = cf.ThreadPoolExecutor(max_workers=max_workers)
    debug = os.environ.get("MAD_TPU_DEBUG_REPLAY")
    t_start = __import__("time").time()

    def compile_one(fn, abstract, ekey):
        import time as _t
        try:
            # the compiled executable is served back to matching proxy
            # calls (first use skips the re-lower + compile)
            t0 = _t.time()
            low = _lower_cached(fn, abstract, ekey)
            t1 = _t.time()
            exe = low.compile()
            _exe_cache[ekey] = exe
            t2 = _t.time()
            # Execute once on zero dummies: whatever a backend defers to
            # first execution (executable loading, one-off setup) then
            # happens in this concurrent pool instead of serializing
            # through the pipeline's first pass.
            _exec_warm(exe, abstract)
            if debug:
                qual = json.loads(ekey)[1]
                print(f"replay> {qual} lower {t1 - t0:.1f}s compile "
                      f"{t2 - t1:.1f}s exec {_t.time() - t2:.1f}s "
                      f"done@{_t.time() - t_start:.1f}s", flush=True)
        except Exception as e:
            if debug:
                print(f"replay> FAIL {json.loads(ekey)[1]}: "
                      f"{type(e).__name__}: {e}", flush=True)

    futures = []
    for fn, abstract, ekey in jobs:
        fut = pool.submit(compile_one, fn, abstract, ekey)
        _track(ekey, fut)
        futures.append(fut)
    pool.shutdown(wait=False)
    if block:
        cf.wait(futures)
        _drop_dummies()
    else:
        threading.Thread(target=lambda: (cf.wait(futures), _drop_dummies()),
                         daemon=True).start()
    return futures


def _blob_dir() -> str:
    from ..core.config import cache_root
    return os.path.join(cache_root(), "hlo")


def _blob_path(ekey: str) -> str:
    import hashlib
    import jax as _jax
    h = hashlib.sha1((_jax.__version__ + ekey).encode()).hexdigest()
    return os.path.join(_blob_dir(), h + ".bin")


def _lower_cached(fn, abstract, ekey):
    """Lowered program for (fn, abstract), via the serialized-StableHLO
    cache when possible. Tracing a big program costs 0.5-7 s of PURE
    Python (GIL-bound — replay threads starve the main thread with it);
    deserializing the exported StableHLO and lowering its call wrapper is
    ~0.3 s of mostly C++. The blob is written on the first (tracing)
    pass, keyed by the executable-reuse key + jax version.

    DISABLED BY DEFAULT (MAD_TPU_HLO_BLOBS=1 to enable): the wrapped
    ``exported.call`` programs miss the compile-cache entries of their
    unwrapped variants even with byte-identical blobs, so the tracing
    saved here is paid back in recompiles. Direct lowering keeps the
    cache keyed on the stable unwrapped HLO."""
    if os.environ.get("MAD_TPU_HLO_BLOBS", "") in ("", "0"):
        return fn.lower(*abstract)
    path = _blob_path(ekey)
    try:
        with open(path, "rb") as f:
            exported = jax.export.deserialize(bytearray(f.read()))
        return jax.jit(exported.call).lower(*abstract)
    except (OSError, ValueError):
        pass
    except Exception:
        try:                       # stale/incompatible blob: drop it
            os.unlink(path)
        except OSError:
            pass
    exported = None
    try:
        exported = jax.export.export(fn)(*abstract)
        blob = exported.serialize()
        os.makedirs(_blob_dir(), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except Exception:
        exported = None
    if exported is not None:
        return jax.jit(exported.call).lower(*abstract)
    return fn.lower(*abstract)


_dummy_lock = threading.Lock()
_dummy_pool: dict = {}     # (shape, dtype) -> device zeros, shared across
                           # warm executions (freed by _drop_dummies)


def _dummy_args(abstract, fresh: bool = False):
    """Zero-filled device arguments matching an abstract signature.

    fresh=True bypasses (and refreshes) the shared pool — needed after a
    donating program consumed a pooled buffer (donation deletes it).

    Small arguments (<=1 MB) are HOST numpy zeros: the executable
    transfers them without dispatching a device fill, so the warm does
    not compile a broadcast program per distinct small shape (measured:
    84 tiny fill compiles per cold process otherwise)."""
    import numpy as _np
    out = []
    for a in abstract:
        if isinstance(a, jax.ShapeDtypeStruct):
            nbytes = int(_np.dtype(a.dtype).itemsize)
            for s in a.shape:
                nbytes *= int(s)
            if nbytes <= (1 << 20):
                out.append(_np.zeros(a.shape, a.dtype))
                continue
            key = (tuple(a.shape), str(a.dtype))
            buf = None
            if not fresh:
                with _dummy_lock:
                    buf = _dummy_pool.get(key)
                if buf is not None and getattr(buf, "is_deleted",
                                               lambda: False)():
                    buf = None
            if buf is None:
                buf = jnp.zeros(a.shape, a.dtype)
                with _dummy_lock:
                    _dummy_pool[key] = buf
            out.append(buf)
        else:
            out.append(a)
    return out


def _drop_dummies() -> None:
    with _dummy_lock:
        _dummy_pool.clear()


def _exec_warm(exe, abstract) -> None:
    """Run a compiled executable once on dummy inputs and wait until the
    execution has finished, by a host pull of the smallest output leaf;
    when every output is large, pull a scalar element instead (the tiny
    gather program it dispatches is compiled once per shape and shared
    in-process)."""
    try:
        try:
            out = exe(*_dummy_args(abstract))
        except Exception:
            # a donating program may have consumed a pooled buffer
            out = exe(*_dummy_args(abstract, fresh=True))
        leaves = [x for x in jax.tree_util.tree_leaves(out)
                  if hasattr(x, "nbytes")]
        if not leaves:
            return
        smallest = min(leaves, key=lambda x: x.nbytes)
        if smallest.nbytes <= (1 << 20):
            jax.device_get(smallest)
        else:
            jax.device_get(smallest[(0,) * smallest.ndim])
    except Exception:
        pass


def _octave_params(grid_shape: Tuple[int, int, int], cfg: MadConfig):
    """(dims, real_shape, upsampled) per octave for a raw grid shape,
    mirroring ops/scalespace._prepare + iter_lazy_octaves."""
    ss = cfg.scalespace
    real = tuple(s + 2 * ss.map_padding for s in grid_shape)
    dims = tuple(bucket(s, cfg.shape_bucket) for s in real)
    out = []
    if ss.oct_mode in ("up", "both"):
        out.append((dims, tuple(2 * s - 1 for s in real), True))
    if ss.oct_mode in ("base", "both"):
        out.append((dims, real, False))
    return out


def pipeline_programs(grid_shape: Tuple[int, int, int], cfg: MadConfig,
                      describe_caps: Sequence[int] = ()):
    """Yield (jitted_fn, abstract_args) for every describe-side program the
    FUSED pipeline (engine/pipeline.describe_grid) will need for a grid of
    ``grid_shape`` (pre-padding voxels): per octave, the fused
    LoG+detect+compaction program, the gradient program, the fused
    orientation+lane-compaction program at the static lane frame, and the
    descriptor program. Capacities are static (cfg.describe.static_lanes),
    so this IS the complete describe-side inventory — no data-dependent
    buckets remain.

    describe_caps: extra lane frames to prewarm (e.g. the max_descriptors
    overflow frame for dense maps).
    """
    from ..core.config import bucket as _bucket
    from ..ops import scalespace as ssp
    from ..ops.describe import _compiled_describe
    from ..ops.orient import _compiled_orient

    ss, det, ori, dsc = cfg.scalespace, cfg.detect, cfg.orient, cfg.describe
    radius = (ori.patch_size - ori.patch_size % 2) // 2
    f32 = jnp.float32
    full_l = min(_bucket(dsc.max_descriptors, 128),
                 det.max_anchors * ori.max_main * ori.max_sec)
    # Frames to prewarm: every rung the frame memory remembers for this
    # grid shape (engine/pipeline sizes the chain from that memory, so
    # those are the programs that actually run); the default speculative
    # frame only when the shape has never been seen.
    frames = set()
    from ..engine import pipeline as _pl
    with _pl._frame_lock:
        mem = dict(_pl._frames_load())
    suffix = f"|{tuple(grid_shape)}"
    for k, caps in mem.items():
        if k.endswith(suffix):
            frames.add((min(int(caps[0]), det.max_anchors),
                        min(int(caps[1]), full_l)))
    if not frames:
        frames.add((min(512, int(det.max_anchors)),
                    min(_bucket(dsc.static_lanes, 128), full_l)))

    octaves = _octave_params(grid_shape, cfg)
    for octave_i, (dims, real_shape, up) in enumerate(octaves):
        vol = jax.ShapeDtypeStruct(dims, f32)
        args = (dims, float(ss.detect_sigma), float(ss.presmooth_sigma),
                up, float(ss.truncate))
        n_vox = 1
        for s in real_shape:
            n_vox *= s
        from ..engine.pipeline import (FUSE_OCTAVE_VOXELS,
                                       _compiled_octave_chain)
        if n_vox <= FUSE_OCTAVE_VOXELS:
            # Mirror describe_grid's whole-octave fused chain exactly,
            # including which octave donates its input (the last one,
            # whenever map padding gives it its own buffer).
            dims_vox = 1
            for s in dims:
                dims_vox *= int(s)
            final = (octave_i == len(octaves) - 1
                     and cfg.scalespace.map_padding > 0)
            dsc_radius = (dsc.patch_size - dsc.patch_size % 2) // 2
            for spec_k, lane_cap in sorted(frames):
                ch_fn = _compiled_octave_chain(
                    tuple(dims), float(ss.detect_sigma),
                    float(ss.presmooth_sigma), bool(up), float(ss.truncate),
                    tuple(real_shape), float(det.threshold_abs),
                    int(det.exclude_border), float(det.max_offset),
                    int(det.newton_iters), int(det.max_anchors),
                    int(spec_k), int(radius), ori.eqsp_size, ori.max_main,
                    ori.max_sec, float(ori.cutoff_magn), float(ori.gw_sig),
                    dsc.subeqsp_size, dsc.subregions,
                    float(dsc.cutoff_magn), float(dsc.zero_magn),
                    int(lane_cap), dsc_radius=int(dsc_radius),
                    donate=bool(final and dims_vox > 8_000_000))
                yield ch_fn, (vol,)
            continue

        gdtype = ("bfloat16" if n_vox > ssp.LazyOctave.BF16_VOXELS
                  else "float32")
        grad_fn = ssp._compiled_grad(*args, dtype=gdtype)
        yield grad_fn, (vol,)
        grad_sd = jax.eval_shape(grad_fn, vol)
        stride = 2 if up else 1

        for spec_k, lane_cap in sorted(frames):
            ld_fn = ssp._compiled_log_detect(
                *args, tuple(real_shape), float(det.threshold_abs),
                int(det.exclude_border), float(det.max_offset),
                int(det.newton_iters), int(det.max_anchors), spec_k)
            yield ld_fn, (vol,)
            ori_fn = _compiled_orient(grad_sd.shape[:3], real_shape, stride,
                                      radius, ori.eqsp_size, ori.max_main,
                                      ori.max_sec, float(ori.cutoff_magn),
                                      float(ori.gw_sig), 128,
                                      lane_cap=lane_cap)
            yield ori_fn, (grad_sd,
                           jax.ShapeDtypeStruct((spec_k, 3), jnp.int32),
                           jax.ShapeDtypeStruct((spec_k,), jnp.bool_))

            for cap in tuple(describe_caps) + (lane_cap,):
                dsc_fn = _compiled_describe(
                    grad_sd.shape[:3], real_shape, bool(up), radius,
                    dsc.subeqsp_size, dsc.subregions,
                    float(dsc.cutoff_magn), float(dsc.zero_magn), 128)
                yield dsc_fn, (grad_sd,
                               jax.ShapeDtypeStruct((cap, 3), jnp.int32),
                               jax.ShapeDtypeStruct((cap, 3, 3), f32),
                               jax.ShapeDtypeStruct((cap,), jnp.bool_))


def warm_pipeline(grid_shapes: Iterable[Tuple[int, int, int]],
                  cfg: Optional[MadConfig] = None,
                  describe_caps: Sequence[int] = (),
                  max_workers: int = 8, block: bool = True):
    """AOT-compile the describe-side programs for the given grid shapes on
    a thread pool. Returns the executor's futures; with block=True waits
    and surfaces the first failure."""
    cfg = cfg or MadConfig()
    try:
        platform = jax.default_backend()
    except Exception:
        platform = ""
    seen = set()
    jobs = []
    for shape in grid_shapes:
        for fn, abstract in pipeline_programs(tuple(shape), cfg,
                                              describe_caps):
            key = (id(fn), tuple((a.shape, str(a.dtype)) for a in abstract))
            if key in seen:
                continue
            seen.add(key)
            # predictive compiles feed the same executable cache replay
            # uses, so the pipeline's first calls skip the compile too
            ekey = None
            if isinstance(fn, _WarmProxy) and platform:
                sig = _sig_of(abstract)
                if sig is not None:
                    ekey = _exe_key(platform, fn._qual, fn._args,
                                    fn._kwargs, _masked(sig))
                    if ekey in _exe_cache:
                        continue
                fn = fn._fn
            jobs.append((fn, abstract, ekey))

    pool = cf.ThreadPoolExecutor(max_workers=max_workers)

    def compile_one(fn, abstract, ekey):
        low = (_lower_cached(fn, abstract, ekey) if ekey is not None
               else fn.lower(*abstract))
        exe = low.compile()
        if ekey is not None:
            _exe_cache[ekey] = exe
        _exec_warm(exe, abstract)   # run once on dummies
        return exe

    futures = []
    for fn, abstract, ekey in jobs:
        fut = pool.submit(compile_one, fn, abstract, ekey)
        if ekey is not None:
            _track(ekey, fut)
        futures.append(fut)
    pool.shutdown(wait=False)
    if block:
        for f in futures:
            f.result()
        _drop_dummies()
    elif futures:
        threading.Thread(target=lambda: (cf.wait(futures), _drop_dummies()),
                         daemon=True).start()
    return futures
