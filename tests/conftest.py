"""Test configuration: the CPU backend with an 8-device virtual mesh.

Multi-device sharding is validated on virtual CPU devices; tests that
need the GPU are marked `gpu` and skip here (they run on the card
through chip_smoke.py).
"""

import os

# the CPU unless a caller chose a platform (chip_smoke.py runs the gpu
# tests in its own process, whose backend is already the GPU)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)
