"""Test config: run JAX on a virtual 8-device CPU mesh.

Unit tests must be hermetic and able to test multi-device sharding
without hardware, so unless JAX_PLATFORMS names another platform the
tests run on the CPU with 8 virtual devices and Pallas kernels in
interpret mode. Tests marked `chip` need a CUDA GPU and skip elsewhere;
`python chip_smoke.py` runs them on the card.
"""

import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "cdsearch"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where JAX has none."""
    import jax
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a CUDA GPU (run through chip_smoke.py)")
    return devices[0]
