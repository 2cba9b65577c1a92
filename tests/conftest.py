"""Test configuration.

The suite runs on the CPU: JAX_PLATFORMS=cpu and a virtual 8-device CPU
platform are set here, before jax is imported, so that the sharded mesh
paths are exercised without accelerator hardware. What only the GPU can
run is a phase of chip_smoke.py, not a test.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

from fulgor_tpu.compile_cache import enable_compile_cache  # noqa: E402

# persistent compile cache: the mini-dictionary probe graphs are large and
# recompiling them on every pytest run dominates suite time
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "device: CPU smoke subset (tiny widths, one pass through each query "
        "strategy's jitted graph on the CPU backend); run with -m device",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
