"""Test configuration: force the CPU platform with 8 virtual devices so
multi-device sharding tests run without a GPU, and trace kernels run in
Pallas interpret mode.

Tests marked `gpu` run the checks of chip_smoke.py on a card; here they
skip. The `gpu` fixture decides at run time, never at import: pytest-xdist
workers must all collect the same tests. On a machine with a card:
    python -m pytest tests/ -m gpu -p no:xdist
with JAX_PLATFORMS unset and FEMBRAIN_TEST_GPU=1 (the default keeps tests
on the CPU).
"""
import os
import sys
from pathlib import Path

import pytest

if os.environ.get("FEMBRAIN_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: production-scale tests (tens of seconds)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (runs chip_smoke.py's checks)"
    )


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skip otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; found {dev.platform}")
    return dev
