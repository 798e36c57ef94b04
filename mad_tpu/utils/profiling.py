"""Per-stage timing + optional device profiling.

Replaces the reference's ad-hoc wall-clock accumulators
(mad/Orientator.py:57-61, 275-288; mad/Descriptor.py:99, 208-215) with a
process-wide stage-timer registry, and wraps ``jax.profiler`` for device
traces when requested.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import jax

_STAGES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_HBM_PEAK: Dict[str, int] = defaultdict(int)


def _hbm_enabled() -> bool:
    return os.environ.get("MAD_TPU_HBM", "") not in ("", "0")


def device_bytes_in_use() -> int:
    """Current device allocation in bytes (0 when the backend does not
    expose memory_stats, e.g. CPU)."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        return int(stats.get("bytes_in_use", 0)) if stats else 0
    except Exception:
        return 0


@contextlib.contextmanager
def stage(name: str, sync: bool = False):
    """Accumulate wall-clock for a named pipeline stage.

    Yields a list. With sync=True the timer stops only once every array
    the block appended to it is ready: a GPU runs programs on several
    streams, so only waiting on the stage's own outputs fences its work
    (a fresh transfer such as ``device_put(0.0)`` can finish first).

    MAD_TPU_HBM=1 additionally samples device bytes_in_use at the stage
    boundary and keeps the per-stage high-water mark (the donation /
    memory audit for the big volumes, SURVEY §5 sanitizers row); each
    sample is one backend RPC, so the mode stays opt-in."""
    t0 = time.perf_counter()
    fence: list = []
    try:
        yield fence
    finally:
        if sync:
            jax.block_until_ready(fence)
        if _hbm_enabled():
            b = device_bytes_in_use()
            if b > _HBM_PEAK[name]:
                _HBM_PEAK[name] = b
        _STAGES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def card_info() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints (one line per card), read by a child process that stays off
    JAX; "not available" where nvidia-smi is missing or fails."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else "not available"


def show_timing(reset: bool = False) -> Dict[str, float]:
    """Print the per-stage table (parity: Orientator.show_timing)."""
    total = sum(_STAGES.values())
    print("MaD> Step timing:")
    for name in sorted(_STAGES, key=_STAGES.get, reverse=True):
        hbm = (" | HBM %6.2f GB" % (_HBM_PEAK[name] / (1 << 30))
               if _HBM_PEAK.get(name) else "")
        print("     %-24s %8.2f s  (%d calls)%s"
              % (name, _STAGES[name], _COUNTS[name], hbm))
    print("     %-24s %8.2f s" % ("Total:", total))
    out = dict(_STAGES)
    if reset:
        _STAGES.clear()
        _COUNTS.clear()
        _HBM_PEAK.clear()
    return out


def hbm_peaks() -> Dict[str, int]:
    """Per-stage device-allocation high-water marks (MAD_TPU_HBM=1)."""
    return dict(_HBM_PEAK)


def get_timings() -> Dict[str, float]:
    return dict(_STAGES)


@contextlib.contextmanager
def device_trace(logdir: str = ""):
    """jax.profiler trace around a block (view with tensorboard/xprof);
    the default directory is ``mad_tpu_trace`` under the temp dir."""
    import tempfile
    logdir = logdir or os.path.join(tempfile.gettempdir(), "mad_tpu_trace")
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
