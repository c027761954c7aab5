"""HMC + dual averaging + RMHMC tests (reference ``tests/samplers/test_hmc.py``, 1,516 LoC)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import DoubleWellEnergy, GaussianEnergy
from torchebm_tpu.samplers import HamiltonianMonteCarlo, RiemannianManifoldHMC


def test_gaussian_moments(key):
    mean = jnp.array([2.0, -1.0])
    cov = jnp.array([[1.0, 0.0], [0.0, 2.0]])
    hmc = HamiltonianMonteCarlo(GaussianEnergy.create(mean, cov), step_size=0.2, n_leapfrog_steps=10)
    samples = hmc.sample(key, dim=2, n_samples=2000, n_steps=500)
    np.testing.assert_allclose(jnp.mean(samples, 0), mean, atol=0.12)
    np.testing.assert_allclose(jnp.var(samples, 0), jnp.diagonal(cov), rtol=0.15)


def test_acceptance_rate_behavior(key):
    """Small step size -> acceptance near 1; huge step size -> low acceptance."""
    e = GaussianEnergy.standard(2)
    small = HamiltonianMonteCarlo(e, step_size=0.05, n_leapfrog_steps=5)
    _, d_small = small.sample(key, dim=2, n_samples=256, n_steps=50, return_diagnostics=True)
    assert float(d_small["acceptance_rate"].mean()) > 0.95
    big = HamiltonianMonteCarlo(e, step_size=2.5, n_leapfrog_steps=5)
    _, d_big = big.sample(key, dim=2, n_samples=256, n_steps=50, return_diagnostics=True)
    assert float(d_big["acceptance_rate"].mean()) < 0.6


def test_mass_matrix(key):
    e = GaussianEnergy.standard(2)
    hmc_s = HamiltonianMonteCarlo(e, step_size=0.2, n_leapfrog_steps=5, mass=2.0)
    hmc_v = HamiltonianMonteCarlo(e, step_size=0.2, n_leapfrog_steps=5, mass=jnp.array([2.0, 2.0]))
    a = hmc_s.sample(key, dim=2, n_samples=64, n_steps=20)
    b = hmc_v.sample(key, dim=2, n_samples=64, n_steps=20)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_reproducibility(key):
    hmc = HamiltonianMonteCarlo(GaussianEnergy.standard(2), step_size=0.2, n_leapfrog_steps=5)
    a = hmc.sample(key, dim=2, n_samples=32, n_steps=20)
    b = hmc.sample(key, dim=2, n_samples=32, n_steps=20)
    np.testing.assert_array_equal(a, b)


def test_validation():
    with pytest.raises(ValueError):
        HamiltonianMonteCarlo(GaussianEnergy.standard(2), n_leapfrog_steps=0)
    with pytest.raises(TypeError):
        HamiltonianMonteCarlo(GaussianEnergy.standard(2), integrator="generalised_leapfrog")


@pytest.mark.slow
def test_dual_averaging_hits_target(key):
    """Build addition (BASELINE): warmup adapts step size toward target acceptance."""
    e = GaussianEnergy.standard(2)
    hmc = HamiltonianMonteCarlo(e, step_size=1.9, n_leapfrog_steps=5, dual_averaging=True, target_accept=0.8)
    x, eps = hmc.warmup(key, dim=2, n_warmup=400, n_samples=512)
    assert 0.05 < eps < 1.9  # adapted downward from a too-large start
    _, diag = hmc.replace(step_size=eps).sample(
        jax.random.fold_in(key, 1), x=x, n_steps=200, return_diagnostics=True
    )
    acc = float(diag["acceptance_rate"].mean())
    assert 0.6 < acc <= 1.0, acc


def test_double_well_both_modes(key):
    hmc = HamiltonianMonteCarlo(DoubleWellEnergy(), step_size=0.1, n_leapfrog_steps=10)
    s = hmc.sample(key, dim=1, n_samples=1000, n_steps=300)
    frac_pos = float(jnp.mean(s > 0))
    assert 0.2 < frac_pos < 0.8  # both wells populated


# ---------------------------------------------------------------- RMHMC


def _identity_metric(x):
    d = x.shape[-1]
    return jnp.broadcast_to(jnp.eye(d), (x.shape[0], d, d))


def test_rmhmc_identity_metric_moments(key):
    e = GaussianEnergy.standard(2)
    rm = RiemannianManifoldHMC(e, metric_fn=_identity_metric, step_size=0.3, n_leapfrog_steps=5)
    s = rm.sample(key, dim=2, n_samples=500, n_steps=300)
    np.testing.assert_allclose(jnp.mean(s, 0), jnp.zeros(2), atol=0.15)
    np.testing.assert_allclose(jnp.var(s, 0), jnp.ones(2), rtol=0.25)


def test_rmhmc_position_dependent_metric_runs(key):
    e = GaussianEnergy.standard(2)

    def metric(x):
        d = x.shape[-1]
        scale = 1.0 + jnp.sum(x**2, axis=-1, keepdims=True)[..., None]
        return scale * jnp.broadcast_to(jnp.eye(d), (x.shape[0], d, d))

    rm = RiemannianManifoldHMC(e, metric_fn=metric, step_size=0.1, n_leapfrog_steps=3)
    s, diag = rm.sample(key, dim=2, n_samples=64, n_steps=50, return_diagnostics=True)
    assert bool(jnp.all(jnp.isfinite(s)))
    assert float(diag["acceptance_rate"].mean()) > 0.5


def test_rmhmc_validation():
    e = GaussianEnergy.standard(2)
    with pytest.raises(TypeError):
        RiemannianManifoldHMC(e, metric_fn=None)
    with pytest.raises(TypeError):
        RiemannianManifoldHMC(e, metric_fn=_identity_metric, integrator="leapfrog")


class TestMassAdaptation:
    def test_adapted_mass_matches_inverse_variance(self, key):
        """Anisotropic Gaussian diag(1, 25): Stan-style adaptation should
        recover mass ~ [1, 0.04] (inverse posterior variance)."""
        cov = jnp.diag(jnp.array([1.0, 25.0]))
        hmc = HamiltonianMonteCarlo(
            GaussianEnergy.create(jnp.zeros(2), cov),
            step_size=0.3, n_leapfrog_steps=10, dual_averaging=True,
        )
        x, eps, mass = hmc.warmup(
            key, dim=2, n_warmup=600, n_samples=256, adapt_mass=True
        )
        assert mass.shape == (2,)
        assert 0.4 < float(mass[0]) < 2.5
        assert 0.015 < float(mass[1]) < 0.1
        assert float(mass[0]) / float(mass[1]) > 8.0

    def test_adapted_mass_improves_mixing(self, key):
        """Short trajectories (L=2) on a 1-vs-400 anisotropic Gaussian: with
        unit mass the step size is pinned by the tight dimension and the wide
        one random-walks; the adapted metric rescales both to unit scale, so
        the min-ESS gap is large."""
        from torchebm_tpu.samplers import summarize_chains

        cov = jnp.diag(jnp.array([1.0, 400.0]))
        e = GaussianEnergy.create(jnp.zeros(2), cov)
        hmc = HamiltonianMonteCarlo(e, step_size=0.2, n_leapfrog_steps=2,
                                    dual_averaging=True)
        k1, k2 = jax.random.split(key)
        x, eps, mass = hmc.warmup(k1, dim=2, n_warmup=500, n_samples=64,
                                  adapt_mass=True)
        plain = hmc.replace(step_size=eps)
        tuned = hmc.replace(step_size=eps, mass=mass)
        t_plain = plain.sample(k2, x=x, n_steps=400, return_trajectory=True)
        t_tuned = tuned.sample(k2, x=x, n_steps=400, return_trajectory=True)
        ess_plain = float(jnp.min(summarize_chains(t_plain)["ess"]))
        ess_tuned = float(jnp.min(summarize_chains(t_tuned)["ess"]))
        assert ess_tuned > 2.0 * ess_plain, (ess_plain, ess_tuned)

    def test_default_return_signature_unchanged(self, key):
        hmc = HamiltonianMonteCarlo(GaussianEnergy.standard(2), step_size=0.2)
        out = hmc.warmup(key, dim=2, n_warmup=50, n_samples=16)
        assert len(out) == 2


