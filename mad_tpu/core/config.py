"""Typed configuration for the mad_tpu pipeline.

The reference (LBM-EPFL/MaD) passes all knobs as ``run()`` kwargs with
defaults spread over constructors (``mad/MaD.py:87``, ``mad/Orientator.py:13``,
``mad/Descriptor.py:14``, ``mad/MapSpace.py:13``). Here every knob lives in one
frozen dataclass so jitted kernels can treat them as static hashable state.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import os as _os

import jax

# The pipeline's numerics assume float32 accumulation: LoG peak thresholds,
# subvoxel Newton solves and pose rotations all sit well below bf16
# resolution. On the GPU any lower setting lets float32 products run as
# single-pass TF32 (about three decimal digits). Call sites that choose
# their own precision name it (engine/match.SIMILARITY_PRECISION).
jax.config.update("jax_default_matmul_precision", "highest")

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))


def cache_root() -> str:
    """Root directory for the program's persistent state (warm manifest,
    HLO blobs, frame memory, and the XLA cache unless
    ``JAX_COMPILATION_CACHE_DIR`` names another). ``MAD_TPU_CACHE``
    overrides; the default is one fixed directory inside the checkout, so
    repeat runs from the same checkout find it again."""
    return _os.environ.get("MAD_TPU_CACHE") or _os.path.join(_CHECKOUT,
                                                             ".jax_cache")


def xla_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads it itself and this
    module sets nothing), else ``<cache_root>/xla``."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(cache_root(), "xla"))


# Persistent compilation cache: the pipeline compiles one program per
# (bucketed) grid shape; caching them across processes turns repeat runs
# from minutes of XLA compilation into cache hits. CPU runs (tests,
# virtual-mesh dryruns) skip it: XLA:CPU executables bake tuning
# pseudo-features into their target machine list, so the loader flags
# every reload as a machine mismatch, and CPU compiles of the test shapes
# are fast anyway.
if ("cpu" not in _os.environ.get("JAX_PLATFORMS", "").lower()
        and not _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def set_nan_checks(enabled: bool = True) -> None:
    """Global numerical sanitizer (SURVEY §5): when enabled, every jitted
    stage re-runs un-jitted on the first NaN/inf and raises at the exact
    primitive that produced it. Costs recompiles + checks on each call, so
    it is debug-only — reachable via ``MAD_TPU_NANCHECK=global``.

    ``MAD_TPU_NANCHECK=1`` enables the cheaper STAGE mode instead
    (utils/sanitize.py): async isfinite reductions folded into the
    pipeline's consolidated host pulls localize a NaN to its stage with no
    recompiles; use =global afterwards to find the primitive."""
    jax.config.update("jax_debug_nans", bool(enabled))
    jax.config.update("jax_debug_infs", bool(enabled))


if _os.environ.get("MAD_TPU_NANCHECK", "").lower() in ("global", "2"):
    set_nan_checks(True)


@dataclasses.dataclass(frozen=True)
class ScaleSpaceConfig:
    """Scale-space construction (reference: mad/MapSpace.py:13,69-189)."""

    detect_sigma: float = 2.0      # sig_init: LoG / Gaussian sigma (voxels)
    presmooth_sigma: float = 1.0   # smoothing after x2 upsample
    map_padding: int = 9           # zero padding around the input grid
    oct_mode: str = "both"         # "base" | "up" | "both"
    truncate: float = 4.0          # Gaussian kernel truncation, in sigmas


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Anchor detection (reference: mad/Detector.py:18-123)."""

    threshold_abs: float = 5e-2    # min LoG response for a peak
    exclude_border: int = 12       # voxels excluded at each octave border
    max_offset: float = 0.6        # Newton subvoxel offset acceptance bound
    newton_iters: int = 5          # max Newton relocalization steps
    max_anchors: int = 4096        # static per-octave anchor capacity (new)


@dataclasses.dataclass(frozen=True)
class OrientConfig:
    """Orientation assignment (reference: mad/Orientator.py:13-110)."""

    eqsp_size: int = 112           # zones of the orientation histogram sphere
    max_main: int = 6              # max candidate dominant bins per anchor
    max_sec: int = 6               # max candidate secondary bins
    patch_size: int = 16           # full patch diameter (radius = patch_size//2)
    cutoff_magn: float = 1e-5      # gradient magnitudes below this count as 0
    gw_sig: float = 0.0            # optional Gaussian window sigma (0 = off)


@dataclasses.dataclass(frozen=True)
class DescribeConfig:
    """Descriptor generation (reference: mad/Descriptor.py:14-96)."""

    subeqsp_size: int = 16         # zones per subregion histogram
    subregions: int = 64           # 64 | 27 | 8 | 1 spatial subregions
    patch_size: int = 16           # lattice diameter (16**3 sample points)
    cutoff_magn: float = 1e-12     # normalize cutoff
    zero_magn: float = 1e-5        # samples below this excluded from counts
    max_descriptors: int = 16384   # static capacity for oriented anchors
    static_lanes: int = 2048       # fused-path lane frame (one compiled
                                   # describe program per shape; octaves
                                   # with more valid lanes redo at the
                                   # max_descriptors frame)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching + pose scoring (reference: mad/MaD.py:414-453)."""

    cc_threshold: float = 0.6      # min cosine similarity between descriptors
    anchor_dist: float = 4.0       # repeatability correspondence radius (A)
    max_pairs: int = 65536         # static capacity of candidate pairs
    row_cap: int = 128             # per-subunit-descriptor pair candidates
    exact_top: int = 1024          # pairs re-scored with exact NN distances


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Pose clustering / filtering (reference: mad/MaD.py:456-553)."""

    weight_threshold: int = 4      # min cluster weight
    n_samples: int = 60            # top-by-repeatability poses clustered
    rmsd_cloud: float = 10.0       # cloud-RMSD threshold for a new cluster
    min_repeat: float = 5.0        # floor of the repeatability cut
    repeat_frac: float = 0.3       # keep clusters with repeat >= frac * best
    # Rescue rounds (new capability; the reference stops after one pass):
    # after refinement, pairs whose map anchor is not explained by any
    # solution get a fresh n_samples clustering budget under the SAME
    # weight/repeat gates (repeat gate relative to the full table's best).
    # Recovers marginal copies whose pairs rank below the first-round
    # cutoff. Defaults to 0 = reference-parity output; opt in with 1+
    # (bench.py and scripts/stress_large.py do).
    rescue_rounds: int = 0


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Rigid-body refinement (reference: mad/structure_utils.py:58-161)."""

    n_steps: int = 500
    max_step: float = 1.0
    min_step: float = 0.1
    batch_size: int = 4            # steps between step-size halving checks
    dedup_rmsd: float = 6.0        # CA-RMSD merging threshold post-refine
    segment_steps: int = 128       # compact converged candidates after this
                                   # many steps (0 = monolithic loop)
    cascade: bool = True           # on-device survivor compaction: the whole
                                   # refinement (halving lane frames included)
                                   # runs as ONE program with zero host syncs;
                                   # False = host-synced segmented/monolithic
    field_dtype: str = "float32"   # packed gradient-field storage (bfloat16
                                   # halves the gather row size)


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Assembly building (reference: mad/MaD.py:192-223,632-843)."""

    max_models: int = 10
    max_overlap: float = 0.1
    sim_resolution: float = 5.0    # low-res sim for overlap grids
    sim_voxsp: float = 2.0
    sim_isovalue: float = 0.2
    cc_resolution: float = 4.0     # resolution for final model CC


@dataclasses.dataclass(frozen=True)
class MadConfig:
    """Full pipeline configuration with reference defaults."""

    scalespace: ScaleSpaceConfig = ScaleSpaceConfig()
    detect: DetectConfig = DetectConfig()
    orient: OrientConfig = OrientConfig()
    describe: DescribeConfig = DescribeConfig()
    match: MatchConfig = MatchConfig()
    filter: FilterConfig = FilterConfig()
    refine: RefineConfig = RefineConfig()
    assembly: AssemblyConfig = AssemblyConfig()
    # Concurrent AOT compilation of the describe-side programs at session
    # start (utils/warmup.py); cold starts are compile-bound.
    warm_start: bool = True

    # Bucketing granularity for grid shapes; bounds XLA recompiles when
    # many different map sizes flow through the jitted kernels.
    shape_bucket: int = 32

    def replace(self, **kw) -> "MadConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_run_kwargs(
        detect_sigma: float = 2.0,
        presmooth_sigma: float = 1.0,
        ori_eqsp_size: int = 112,
        dsc_eqsp_size: int = 16,
        dsc_subregions: int = 64,
        patch_size: int = 16,
        cc_threshold: float = 0.6,
        weight_threshold: int = 4,
        n_samples: int = 60,
        base: "MadConfig" = None,
    ) -> "MadConfig":
        """Build a config from the reference ``run()`` kwarg surface
        (parity with mad/MaD.py:87). ``base`` supplies every knob the
        kwarg surface does not cover (defaults to a fresh MadConfig)."""
        base = base or MadConfig()
        return base.replace(
            scalespace=dataclasses.replace(
                base.scalespace,
                detect_sigma=detect_sigma,
                presmooth_sigma=presmooth_sigma,
            ),
            orient=dataclasses.replace(
                base.orient, eqsp_size=ori_eqsp_size, patch_size=patch_size
            ),
            describe=dataclasses.replace(
                base.describe,
                subeqsp_size=dsc_eqsp_size,
                subregions=dsc_subregions,
                patch_size=patch_size,
            ),
            match=dataclasses.replace(base.match, cc_threshold=cc_threshold),
            filter=dataclasses.replace(
                base.filter,
                weight_threshold=weight_threshold,
                n_samples=n_samples,
            ),
        )


def bucket(n: int, b: int) -> int:
    """Round up to a multiple of b (shape bucketing for static-shape jit)."""
    return ((int(n) + b - 1) // b) * b
