"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding tests use CPU-simulated devices per
``XLA_FLAGS=--xla_force_host_platform_device_count``; the Triton kernels
run in interpret mode here.  Tests marked ``gpu`` need an NVIDIA GPU and
skip elsewhere; on a machine with the card run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (the CPU backend
serves their host-side references).
"""

import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402  (import after env is set)

if os.environ["JAX_PLATFORMS"] == "cpu":
    # an installed accelerator plugin can register itself regardless of
    # JAX_PLATFORMS; this keeps the run on the CPU
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX found none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu"
        )
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    A full-suite run accumulates every module's jitted programs in one
    process; without per-module clearing XLA's CPU compiler has crashed
    under the memory pressure of the large interpret-mode kernel
    compilations.  Per-module compile reuse is unaffected."""
    yield
    jax.clear_caches()
