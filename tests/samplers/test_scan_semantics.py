"""Sampler semantics on the compiled scan path.

MALA's exact Metropolis correction, parallel tempering's swap sweep and
short chains, AIS log-Z estimates against closed forms, and HMC with a
diagonal mass — each run through the samplers' public API.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import DoubleWellEnergy, GaussianEnergy, GaussianMixtureEnergy
from torchebm_tpu.samplers import (
    HamiltonianMonteCarlo,
    MetropolisAdjustedLangevin,
    ParallelTemperingLangevin,
    annealed_importance_sampling,
)


@pytest.mark.parametrize("step_size", [0.05, 0.1, 0.3])
def test_mala_preserves_its_target(key, step_size):
    """Exact detailed balance: chains started AT exact draws stay at the
    target's moments even with a coarse step."""
    mix = GaussianMixtureEnergy.create(jnp.array([[0.0, 1.5], [0.0, -1.5]]), scale=0.5)
    x0 = mix.sample(key, 2048)
    out, diag = MetropolisAdjustedLangevin(mix, step_size=step_size).sample(
        jax.random.fold_in(key, 1), x=x0, n_steps=20, return_diagnostics=True
    )
    assert 0.3 < float(jnp.mean(diag["acceptance_rate"])) <= 1.0
    np.testing.assert_allclose(np.asarray(out.mean(0)), np.asarray(x0.mean(0)), atol=0.1)
    np.testing.assert_allclose(np.asarray(out.var(0)), np.asarray(x0.var(0)), rtol=0.15)


@pytest.mark.parametrize("temps", [(1.0, 1.5), (1.0, 2.0, 4.0)])
def test_pt_swaps_fire(key, temps):
    """Adjacent replicas exchange: the swap acceptance is positive."""
    pt = ParallelTemperingLangevin(
        DoubleWellEnergy(barrier_height=2.0), temperatures=temps, step_size=0.02,
        swap_every=2,
    )
    _, diag = pt.sample(key, dim=1, n_samples=256, n_steps=40, return_diagnostics=True)
    assert float(jnp.max(diag["swap_acceptance_rate"])) > 0.05


@pytest.mark.parametrize("n_steps", [1, 2, 4])
def test_pt_short_chain_runs_no_sweep(key, n_steps):
    """Fewer steps than swap_every: no exchange runs, the cold chain is a
    plain Langevin chain at temperature 1, and outputs keep their shapes."""
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2), temperatures=(1.0, 3.0), step_size=0.05, swap_every=5
    )
    out, diag = pt.sample(key, dim=2, n_samples=16, n_steps=n_steps, return_diagnostics=True)
    assert out.shape == (16, 2) and bool(jnp.all(jnp.isfinite(out)))
    assert float(jnp.max(diag["swap_acceptance_rate"])) == 0.0


def test_pt_run_replicas_keeps_ladder(key):
    pt = ParallelTemperingLangevin(
        GaussianMixtureEnergy.eight_gaussians(), temperatures=(1.0, 2.0), step_size=0.05
    )
    ladder = jax.random.normal(key, (2, 32, 2))
    new, acc = pt.run_replicas(jax.random.fold_in(key, 1), ladder, 12)
    assert new.shape == ladder.shape and 0.0 <= float(acc) <= 1.0


def test_ais_log_z_of_normalized_mixture(key):
    """E = -log p of a normalized mixture has Z = 1: log Z must come out 0
    (a wrong normalizing constant in the weight update shows here)."""
    mix = GaussianMixtureEnergy.create(jnp.array([[1.5, 0.0], [-1.5, 0.0]]), scale=0.6)
    base = GaussianEnergy.create(jnp.zeros(2), 4.0 * jnp.eye(2))
    res = annealed_importance_sampling(
        key, mix, base=base, n_samples=1024, n_rungs=60, step_size=0.15
    )
    assert abs(float(res.log_z)) < 0.2, float(res.log_z)
    assert 0.2 < float(res.acceptance_rate) <= 1.0


@pytest.mark.parametrize(
    "cov", [((1.0, 0.4), (0.4, 0.8)), ((2.0, -0.3), (-0.3, 0.5))], ids=["pos", "neg"]
)
def test_ais_log_z_of_gaussian_precision_target(key, cov):
    """A full-covariance Gaussian e^{-E} has log Z = log 2π + ½ log|Σ|."""
    cov = jnp.array(cov)
    target = GaussianEnergy.create(jnp.array([0.5, -0.5]), cov)
    base = GaussianEnergy.create(jnp.zeros(2), 2.0 * jnp.eye(2))
    res = annealed_importance_sampling(
        key, target, base=base, n_samples=1024, n_rungs=80, step_size=0.1
    )
    want = math.log(2 * math.pi) + 0.5 * float(jnp.linalg.slogdet(cov)[1])
    np.testing.assert_allclose(float(res.log_z), want, atol=0.15)


@pytest.mark.parametrize("mass", [(1.0, 4.0), (0.25, 2.0)])
def test_hmc_diagonal_mass_targets_the_model(key, mass):
    """A per-dimension mass changes the dynamics, never the target."""
    cov = jnp.diag(jnp.array([0.5, 2.0]))
    e = GaussianEnergy.create(jnp.array([1.0, -1.0]), cov)
    hmc = HamiltonianMonteCarlo(e, step_size=0.2, n_leapfrog_steps=8, mass=jnp.array(mass))
    out = hmc.sample(key, dim=2, n_samples=2048, n_steps=60)
    np.testing.assert_allclose(np.asarray(out.mean(0)), [1.0, -1.0], atol=0.1)
    np.testing.assert_allclose(np.asarray(out.var(0)), [0.5, 2.0], rtol=0.15)
