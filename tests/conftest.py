"""Test harness: force an 8-device virtual CPU platform.

The platform is switched through jax.config before any backend is
created, so the multi-device sharding tests run on a virtual CPU mesh
whatever JAX_PLATFORMS says. GPU checks live in chip_smoke.py, which runs
on the card (README, "Running"); tests that need a card carry the ``gpu``
marker and take the ``gpu_device`` fixture, which skips without one.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips where JAX has none"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU of this process, decided when a test asks for it."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this process; chip_smoke.py runs the GPU "
                    "checks on the card")
