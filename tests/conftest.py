"""Test configuration: unless JAX_PLATFORMS says otherwise, run on the CPU
with an 8-device virtual mesh (set BEFORE jax import) so multi-device
sharding tests run without accelerators (SURVEY.md §4). Tests that need a
GPU take the ``gpu`` fixture and skip without one."""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from pbrpathtracer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
# Reverse-mode renderer jits are expensive to compile; cache them.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
