"""AIS log-Z estimation tests (build addition — no reference analogue).

Ground truths: Gaussian targets have closed-form log Z; GaussianMixtureEnergy
is a *normalized* density, so its log Z is exactly 0.
"""

import math

import jax
import jax.numpy as jnp
import pytest

from torchebm_tpu.core import GaussianEnergy, GaussianMixtureEnergy, HarmonicEnergy
from torchebm_tpu.samplers import annealed_importance_sampling


@pytest.mark.slow
def test_gaussian_log_z(key):
    cov = jnp.array([[2.0, 0.5], [0.5, 1.0]])
    t = GaussianEnergy.create(jnp.array([1.0, -2.0]), cov)
    res = annealed_importance_sampling(key, t, dim=2, n_samples=2000, n_rungs=150)
    assert abs(float(res.log_z) - float(t.log_z())) < 0.1
    assert float(res.ess) > 200  # anneal did not collapse
    assert 0.5 < float(res.acceptance_rate) <= 1.0


@pytest.mark.slow
def test_normalized_mixture_log_z_is_zero(key):
    mix = GaussianMixtureEnergy.eight_gaussians(radius=2.0, scale=0.5)
    res = annealed_importance_sampling(
        key, mix, dim=2, n_samples=2000, n_rungs=300, step_size=0.2
    )
    assert abs(float(res.log_z)) < 0.1


def test_harmonic_log_z(key):
    h = HarmonicEnergy(k=4.0)
    res = annealed_importance_sampling(key, h, dim=3, n_samples=1000, n_rungs=80)
    true = 1.5 * math.log(2 * math.pi / 4)
    assert abs(float(res.log_z) - true) < 0.1


def test_identity_anneal_has_zero_weights(key):
    """base == target: every weight is exactly 0 and log_z == base.log_z()."""
    base = GaussianEnergy.standard(2)
    res = annealed_importance_sampling(key, base, base=base, n_samples=64, n_rungs=10)
    assert float(jnp.max(jnp.abs(res.log_weights))) < 1e-5
    assert abs(float(res.log_z) - float(base.log_z())) < 1e-5
    assert abs(float(res.ess) - 64.0) < 1e-3


def test_custom_betas_and_validation(key):
    t = GaussianEnergy.standard(2)
    betas = jnp.array([0.0, 0.5, 1.0])
    res = annealed_importance_sampling(key, t, dim=2, n_samples=32, betas=betas)
    assert res.samples.shape == (32, 2)
    with pytest.raises(ValueError, match="betas"):
        annealed_importance_sampling(key, t, dim=2, betas=jnp.array([1.0]))
    with pytest.raises(ValueError, match="base"):
        annealed_importance_sampling(key, t)


def test_reproducible(key):
    t = GaussianEnergy.standard(2)
    a = annealed_importance_sampling(key, t, dim=2, n_samples=32, n_rungs=20)
    b = annealed_importance_sampling(key, t, dim=2, n_samples=32, n_rungs=20)
    assert float(jnp.max(jnp.abs(a.log_weights - b.log_weights))) == 0.0


def test_gaussian_energy_sample_and_log_z(key):
    cov = jnp.array([[1.5, -0.4], [-0.4, 0.8]])
    e = GaussianEnergy.create(jnp.array([3.0, -1.0]), cov)
    draws = e.sample(key, 20000)
    assert jnp.allclose(jnp.mean(draws, 0), e.mean, atol=0.05)
    assert jnp.allclose(jnp.cov(draws.T), cov, atol=0.08)
    d = 2
    sign, logdet = jnp.linalg.slogdet(cov)
    assert abs(float(e.log_z()) - (0.5 * d * math.log(2 * math.pi) + 0.5 * float(logdet))) < 1e-6


