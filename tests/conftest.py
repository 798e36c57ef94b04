import os

# Tests run on CPU with a virtual 8-device mesh: deterministic f32 math and
# multi-device sharding logic without hardware. A GPU-enabled JAX would
# otherwise pick the card, so force the platform through the environment
# and jax.config (effective as long as no computation ran yet). Tests that
# need the card carry the ``gpu`` marker and skip here (the ``gpu``
# fixture below).
# MAD_TPU_GPU_TESTS=1 leaves the platform alone, for the card-only tests:
#   MAD_TPU_GPU_TESTS=1 python -m pytest tests/ -m gpu
_ON_CARD = os.environ.get("MAD_TPU_GPU_TESTS", "") not in ("", "0")
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "--xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first device, for tests marked ``gpu``; skips unless it is a
    GPU (decided here at run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, found {dev.platform}: run with "
                    "MAD_TPU_GPU_TESTS=1 on a GPU host")
    return dev
