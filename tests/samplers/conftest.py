"""Fixtures for the samplers' kernel dispatch tests."""

import functools

import pytest


@pytest.fixture
def gpu_dispatch(monkeypatch):
    """Let the samplers dispatch as they do on a GPU backend: the one
    backend predicate (``ops.kernels_enabled``) answers as on a GPU. Tests
    either stub the kernel or also request ``interpret_kernels``."""
    from torchebm_tpu.ops import FUSED_MODES
    from torchebm_tpu.samplers import langevin

    def enabled(fused):
        assert fused in FUSED_MODES
        return fused != "off"

    monkeypatch.setattr(langevin, "kernels_enabled", enabled)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the dispatched kernel through the Pallas interpreter (CPU)."""
    import torchebm_tpu.ops.fused_langevin as fl

    for name in (
        "mixture_langevin_chain",
        "mixture_langevin_chain_trajectory",
        "doublewell_langevin_chain",
        "doublewell_langevin_chain_trajectory",
    ):
        monkeypatch.setattr(
            fl, name, functools.partial(getattr(fl, name), interpret=True)
        )
