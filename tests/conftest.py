"""Test config.

JAX_PLATFORMS comes from the environment and defaults to the CPU, where a
virtual 8-device mesh lets the sharding tests run without accelerators.
x64 is on for parity tests against float64 reference semantics, and the
persistent compile cache is off — through the environment, so processes
the tests start inherit it — so test runs leave no cache behind.

Tests that need a GPU carry the `gpu` marker; the autouse fixture below
skips them unless JAX's default backend is a GPU.  The decision is made
per test, inside the fixture, so every xdist worker collects the same
tests.  On the card: `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card with -m gpu)")
