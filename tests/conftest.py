"""Test configuration: an 8-device virtual CPU mesh + float64.

The suite runs on the CPU: sharding tests use XLA's host-platform virtual
devices.  Tests marked ``gpu`` need a CUDA device; they skip elsewhere and
run on a GPU host with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.  Must run before jax is imported anywhere.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

import safeincave_tpu  # noqa: E402,F401  (enables x64)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is the GPU.

    Decided per test at run time, never at collection, so every xdist
    worker collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a CUDA GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")
