"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(``jax.sharding.Mesh`` + ``shard_map``) are exercised without accelerator
hardware, and with x64 enabled so reference-parity tests can check against
float64 ground truth (the C++ reference is all-double).

Tests that need the GPU take the ``gpu_device`` fixture and carry the
``gpu`` marker; they skip on the CPU. On the card, run them with
``SHERMBOT_GPU_TESTS=1 python -m pytest -m gpu tests/``;
``python chip_smoke.py`` runs the same checks at full size.
"""

import os
import sys

# Must happen before jax is imported anywhere: the suite runs on the CPU
# even on a machine with a GPU, unless the GPU tests are asked for.
GPU_TESTS = os.environ.get("SHERMBOT_GPU_TESTS") == "1"
if not GPU_TESTS:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

if not GPU_TESTS:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return devs[0]
