"""Native host-runtime components (C extension, built on first use).

The device compute path is JAX/XLA; this package holds the native host-side
runtime pieces (fast structure/volume parsers). The extension compiles once
into a per-version directory under the program's cache root and loads from
there; every consumer has
a pure-Python fallback, so the absence of a toolchain only costs speed.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig

from ..core.config import cache_root

_HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE = os.path.join(
    os.environ.get("MAD_TPU_NATIVE_CACHE",
                   os.path.join(cache_root(), "native")),
    f"py{sys.version_info.major}{sys.version_info.minor}")

fastio = None


def _build() -> str:
    os.makedirs(_CACHE, exist_ok=True)
    src = os.path.join(_HERE, "fastio.c")
    out = os.path.join(_CACHE, "fastio" +
                       (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    include = sysconfig.get_path("include")
    cmd = ["gcc", "-O2", "-shared", "-fPIC", f"-I{include}", src, "-o",
           out + ".tmp"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(out + ".tmp", out)
    return out


def _load():
    global fastio
    if fastio is not None:
        return fastio
    try:
        path = _build()
        # Module name must match PyInit_fastio in the C source.
        spec = importlib.util.spec_from_file_location("fastio", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fastio = mod
    except Exception:
        fastio = False  # toolchain unavailable; callers fall back to Python
    return fastio


def get_fastio():
    """The compiled extension module, or None when unavailable."""
    mod = _load()
    return mod or None
