"""Test harness configuration.

Puts JAX on the CPU backend with 8 virtual devices BEFORE jax is imported
anywhere, unless ``JAX_PLATFORMS`` already names a backend — the JAX
analogue of the reference's gloo-on-CPU distributed test harness
(``tests/distributed/dist_harness.py:1-103``): multi-device sharding logic is
exercised on a virtual mesh without real accelerators. Must run at conftest
import time, ahead of any test module importing jax.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and request the
``gpu`` fixture, which skips them elsewhere. On a machine with the card:
``JAX_PLATFORMS=cuda python -m pytest tests/ops tests/samplers -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time, never
    at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest tests/ops tests/samplers -m gpu"
        )


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compiler_state():
    """Clear JAX's compiled-program caches between test modules.

    At ~1000 tests the suite accumulates thousands of compiled CPU
    executables in one process; past ~950 the XLA CPU compiler started
    segfaulting mid-compile (observed in jax 0.9.0 at
    ``compiler.py::backend_compile_and_load`` on a program that compiles
    fine in isolation). Dropping caches per module bounds compiler/arena
    state; the cost is recompilation across module boundaries only.
    """
    yield
    jax.clear_caches()
    gc.collect()
