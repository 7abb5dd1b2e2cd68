"""Test configuration: CPU JAX with 8 virtual devices, so the sharding tests
run on any machine (the multi-device dry-run contract)."""

import os

# CPU unless the caller names a platform (chip_smoke.py runs the `gpu`
# tests on the card in its own process)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import pytest

from syllable_detector_tpu.config.model_format import load_config

# the checked-in sample-geometry net (README: "The sample net")
SAMPLE_TXT = os.path.join(ROOT, "sample_net.txt")


@pytest.fixture(scope="session")
def sample_config():
    return load_config(SAMPLE_TXT)


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.fixture()
def gpu():
    """Card-only tests (marker ``gpu``): skip unless JAX sees a GPU.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
