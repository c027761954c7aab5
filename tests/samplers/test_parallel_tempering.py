"""Parallel-tempered Langevin: exchange mechanics, mixing, API contract.

The reference has no working parallel tempering (constructor stub only,
``torchebm/losses/contrastive_divergence.py:246-263``), so these tests pin the
build's own contract: replica-exchange correctness (swap acceptance in (0,1],
cold-chain stationarity) and the mixing win over plain Langevin on a
multimodal energy.
"""

import jax
import jax.numpy as jnp
import pytest

from torchebm_tpu.core import DoubleWellEnergy, GaussianEnergy
from torchebm_tpu.samplers import LangevinDynamics, ParallelTemperingLangevin


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def test_ctor_validation():
    e = GaussianEnergy.standard(2)
    with pytest.raises(ValueError, match="increasing"):
        ParallelTemperingLangevin(e, temperatures=(1.0, 0.5))
    with pytest.raises(ValueError, match=">= 2"):
        ParallelTemperingLangevin(e, temperatures=(1.0,))
    with pytest.raises(ValueError, match="positive"):
        ParallelTemperingLangevin(e, temperatures=(-1.0, 2.0))
    with pytest.raises(ValueError, match="swap_every"):
        ParallelTemperingLangevin(e, temperatures=(1.0, 2.0), swap_every=0)


def test_sample_shapes_and_trajectory(key):
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2), temperatures=(1.0, 2.0, 4.0), step_size=0.05
    )
    out = pt.sample(key, dim=2, n_samples=16, n_steps=20)
    assert out.shape == (16, 2)
    traj = pt.sample(key, dim=2, n_samples=16, n_steps=20, thin=5, return_trajectory=True)
    assert traj.shape == (16, 4, 2)


def test_swap_acceptance_diagnostic(key):
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2),
        temperatures=(1.0, 1.5, 2.25),
        step_size=0.05,
        swap_every=2,
    )
    _, diag = pt.sample(
        key, dim=2, n_samples=64, n_steps=40, return_diagnostics=True
    )
    acc = diag["swap_acceptance_rate"]
    assert acc.shape == (40,)
    # after the first sweep the acceptance stat must be a real probability;
    # a mild geometric ladder on a Gaussian swaps most of the time
    assert float(acc[-1]) > 0.2
    assert float(acc[-1]) <= 1.0
    assert bool(jnp.all(jnp.isfinite(acc[2:])))


def test_cold_chain_gaussian_moments(key):
    """The returned (cold) chain targets the unmodified model."""
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2),
        temperatures=(1.0, 2.0, 4.0),
        step_size=0.05,
        swap_every=5,
    )
    samples = pt.sample(key, dim=2, n_samples=2048, n_steps=300)
    assert float(jnp.abs(jnp.mean(samples))) < 0.15
    assert float(jnp.abs(jnp.var(samples) - 1.0)) < 0.2


def test_pt_mixes_double_well_where_langevin_cannot(key):
    """Chains started in the left well: plain cold Langevin stays trapped,
    replica exchange ferries mass over the barrier to both wells."""
    e = DoubleWellEnergy(barrier_height=8.0, b=1.0)
    x0 = -jnp.ones((256, 1))
    n_steps = 800

    cold = LangevinDynamics(e, step_size=0.005)
    stuck = cold.sample(key, x=x0, n_steps=n_steps)
    assert float(jnp.mean(stuck > 0)) < 0.05  # trapped in the left well

    pt = ParallelTemperingLangevin(
        e,
        temperatures=(1.0, 3.0, 9.0, 27.0, 81.0),
        step_size=0.005,
        swap_every=5,
    )
    mixed = pt.sample(key, x=x0, n_steps=n_steps)
    right_frac = float(jnp.mean(mixed > 0))
    assert 0.2 < right_frac < 0.8  # crossed the barrier, roughly symmetric


def test_run_replicas_contract(key):
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2), temperatures=(1.0, 2.0), step_size=0.05
    )
    ladder = jnp.zeros((2, 8, 2))
    out, acc = pt.run_replicas(key, ladder, n_steps=10)
    assert out.shape == (2, 8, 2)
    assert bool(jnp.all(out[0] != ladder[0]))
    with pytest.raises(ValueError, match="n_replicas"):
        pt.run_replicas(key, jnp.zeros((3, 8, 2)), n_steps=5)


def test_reproducible_and_decorrelated(key):
    pt = ParallelTemperingLangevin(
        GaussianEnergy.standard(2), temperatures=(1.0, 2.0), step_size=0.05
    )
    a = pt.sample(key, dim=2, n_samples=8, n_steps=25)
    b = pt.sample(key, dim=2, n_samples=8, n_steps=25)
    c = pt.sample(jax.random.PRNGKey(1), dim=2, n_samples=8, n_steps=25)
    assert bool(jnp.all(a == b))
    assert not bool(jnp.all(a == c))


