"""Stationary statistics of the whole-chain kernels with the in-kernel
generator: compiled for the card (``-m gpu``), and at a few hundred chains
through the Pallas interpreter."""

import jax
import jax.numpy as jnp
import pytest

from torchebm_tpu.core import GaussianMixtureEnergy
from torchebm_tpu.ops import doublewell_langevin_chain, mixture_langevin_chain


def _check_stationary(key, n_chains, **kw):
    x = jax.random.normal(key, (n_chains // 2, 4))
    chain = doublewell_langevin_chain(x, 1000, 0.01, 1.0, seed=7, **kw)
    assert 0.6 < float(jnp.mean(jnp.abs(chain))) < 1.2

    mix = GaussianMixtureEnergy.eight_gaussians()
    x2 = jax.random.normal(key, (n_chains, 2))
    res = mixture_langevin_chain(x2, mix.means, 500, 0.05, scale=float(mix.scale),
                                 seed=11, **kw)
    assert 3.5 < float(jnp.mean(jnp.linalg.norm(res, axis=-1))) < 4.5


@pytest.mark.gpu
def test_chain_kernels_stationary(key, gpu):
    _check_stationary(key, 4096)


def test_chain_kernels_stationary_interpreted(key):
    _check_stationary(key, 512, interpret=True)
