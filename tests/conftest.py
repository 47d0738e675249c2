"""Test configuration: the CPU backend with 8 virtual devices by default.

Sharding is checked on XLA's CPU backend with 8 virtual devices.  Tests
that need a GPU carry the ``gpu`` marker and take the ``gpu_devices``
fixture, which skips them at run time where JAX finds no GPU.  Run them on
a machine with a card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

import jax  # noqa: E402

from projectultra.utils import backend  # noqa: E402

# The LDPC while_loop and scan pipelines are slow to compile on the CPU;
# the persistent cache keeps them across runs.
backend.enable_compile_cache()

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "golden")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN_DIR


@pytest.fixture(scope="session")
def gpu_devices():
    """JAX's GPU devices; skips the test where there are none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: JAX finds none here")
    return devices
