"""Test config: an 8-device virtual CPU mesh, set before jax imports.

The tests run on the CPU unless ``JAX_PLATFORMS`` names another platform
(``JAX_PLATFORMS=cuda python -m pytest tests/test_kernels.py -m gpu`` runs
the GPU tests).

Multi-device sharding tests run on xla_force_host_platform_device_count=8
CPU devices (the reference has no fake-cluster fixtures, SURVEY.md §4).
Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU. On the CPU every test
runs the Triton decode kernel — the default decode backend — in the Pallas
interpreter (the autouse ``interpret`` fixture).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# repo root on sys.path so `import nic` works without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """Run the Triton decode kernel in the Pallas interpreter unless the
    test runs on a GPU."""
    import nic.kernels.decode_triton as decode_triton

    if jax.devices()[0].platform != "gpu":
        monkeypatch.setattr(decode_triton, "INTERPRET", True)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided here, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
