"""MALA statistical + behavioral tests (build addition — no reference analogue;
the statistical pattern follows ``tests/samplers/test_langevin_dynamics.py:184``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import CosineScheduler, GaussianEnergy, GaussianMixtureEnergy
from torchebm_tpu.samplers import MetropolisAdjustedLangevin


@pytest.mark.slow
def test_gaussian_sampling_statistics(key):
    mean = jnp.array([1.0, -1.0])
    cov = jnp.array([[1.0, 0.3], [0.3, 0.5]])
    sampler = MetropolisAdjustedLangevin(GaussianEnergy.create(mean, cov), step_size=0.05)
    samples = sampler.sample(key, dim=2, n_samples=5000, n_steps=1500)
    np.testing.assert_allclose(jnp.mean(samples, 0), mean, atol=0.08)
    np.testing.assert_allclose(jnp.cov(samples.T), cov, atol=0.1)


def test_large_step_exactness_vs_unadjusted(key):
    """At an aggressively large step the MH correction keeps the variance
    right where unadjusted Langevin overshoots it (discretization bias
    var -> 1 + eta for ULA on a standard Gaussian)."""
    from torchebm_tpu.samplers import LangevinDynamics

    e = GaussianEnergy.standard(2)
    eta = 0.6
    ula = LangevinDynamics(e, step_size=eta).sample(
        key, dim=2, n_samples=4000, n_steps=400
    )
    mala = MetropolisAdjustedLangevin(e, step_size=eta).sample(
        key, dim=2, n_samples=4000, n_steps=400
    )
    var_ula = float(jnp.var(ula))
    var_mala = float(jnp.var(mala))
    assert var_ula > 1.25  # ULA bias is visible at this step size
    assert abs(var_mala - 1.0) < 0.12  # MALA removes it


def test_acceptance_rate_monotone_in_step_size(key):
    e = GaussianEnergy.standard(4)
    rates = []
    for eta in (0.01, 0.2, 1.5):
        _, diag = MetropolisAdjustedLangevin(e, step_size=eta).sample(
            key, dim=4, n_samples=512, n_steps=100, return_diagnostics=True
        )
        rates.append(float(jnp.mean(diag["acceptance_rate"])))
    assert rates[0] > 0.95
    assert rates[0] > rates[1] > rates[2]


def test_mixture_modes_covered(key):
    mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.4)
    x0 = mix.sample(key, 3000)
    out = MetropolisAdjustedLangevin(mix, step_size=0.05).sample(
        jax.random.fold_in(key, 1), x=x0, n_steps=300
    )
    r = jnp.linalg.norm(out, axis=-1)
    assert abs(float(jnp.mean(r)) - 4.0) < 0.2


def test_same_key_reproduces(key):
    sampler = MetropolisAdjustedLangevin(GaussianEnergy.standard(2), step_size=0.1)
    a = sampler.sample(key, dim=2, n_samples=16, n_steps=50)
    b = sampler.sample(key, dim=2, n_samples=16, n_steps=50)
    np.testing.assert_array_equal(a, b)


def test_scheduled_step_size_runs(key):
    sch = CosineScheduler(0.2, 0.01, 100)
    sampler = MetropolisAdjustedLangevin(GaussianEnergy.standard(2), step_size=sch)
    out = sampler.sample(key, dim=2, n_samples=8, n_steps=100)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_jits_inside_user_program(key):
    sampler = MetropolisAdjustedLangevin(GaussianEnergy.standard(2), step_size=0.1)

    @jax.jit
    def run(k):
        return sampler.sample(k, dim=2, n_samples=8, n_steps=20)

    assert run(key).shape == (8, 2)


