"""Test harness: force CPU with 8 virtual devices so sharding tests run anywhere.

jax_platforms is set through jax.config before any backend is initialized, so
the suite runs on the CPU (unless JAX_PLATFORMS names another platform) even
where a GPU is present. (BASELINE.json config
#5 / SURVEY.md §4: multi-host tests runnable on CPU via
--xla_force_host_platform_device_count.) Tests that need the card carry the
`gpu` marker and skip here.
"""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: the e2e tiers are dominated by jit compiles
# of near-identical pipeline programs; caching them across runs cuts repeat
# full-suite time several-fold. Safe under parallel runs (the cache is
# content-addressed, writes are atomic renames).
from visual_odometry_ros_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips on the CPU")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where JAX finds none (decided at run
    time, never at import, so every xdist worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: this test runs on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(7)
