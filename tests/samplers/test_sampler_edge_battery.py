"""Per-sampler edge-case battery (companion to the integrator battery).

Every MCMC/optimization sampler gets: event-shaped (image-like) states,
single-chain operation, tuple-``dim`` initialization, thin/trajectory shape
consistency at awkward divisors, and finiteness. ``FlowSampler`` is covered
by its own analytic matrix (``test_flow_analytic_matrix.py``).
"""

import jax
import jax.numpy as jnp
import pytest

from torchebm_tpu.core import GaussianEnergy, WrappedEnergy
from torchebm_tpu.samplers import (
    GradientDescentSampler,
    HamiltonianMonteCarlo,
    LangevinDynamics,
    MetropolisAdjustedLangevin,
    NesterovSampler,
    NoUTurnSampler,
    ParallelTemperingLangevin,
    RiemannianManifoldHMC,
)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def _flat_energy():
    """Energy over arbitrary event shapes: E = ||x||^2 / 2 summed over events."""
    return WrappedEnergy(
        fn=lambda x: 0.5 * jnp.sum(x.reshape(x.shape[0], -1) ** 2, axis=-1),
    )


def _samplers():
    e = GaussianEnergy.standard(2)
    flat = _flat_energy()
    return [
        ("langevin", LangevinDynamics(flat, step_size=0.05), flat),
        ("mala", MetropolisAdjustedLangevin(flat, step_size=0.05), flat),
        ("hmc", HamiltonianMonteCarlo(flat, step_size=0.1, n_leapfrog_steps=3), flat),
        ("gd", GradientDescentSampler(flat, step_size=0.1), flat),
        ("nesterov", NesterovSampler(flat, step_size=0.05), flat),
        ("pt", ParallelTemperingLangevin(flat, temperatures=(1.0, 2.0), step_size=0.05), flat),
        ("nuts", NoUTurnSampler(e, step_size=0.3, max_tree_depth=3), e),
        (
            "rmhmc",
            RiemannianManifoldHMC(
                e,
                metric_fn=lambda x: jnp.broadcast_to(jnp.eye(2), (x.shape[0], 2, 2)),
                step_size=0.1,
                n_leapfrog_steps=2,
            ),
            e,
        ),
    ]


IDS = [name for name, _, _ in _samplers()]


@pytest.mark.parametrize("name,sampler,energy", _samplers(), ids=IDS)
def test_event_shaped_state(name, sampler, energy, key):
    """Image-like (B, C, H, W) states sample cleanly (chains-as-batch is the
    only special axis). NUTS/RMHMC pin a (B, d) state by construction."""
    if name in ("nuts", "rmhmc"):
        pytest.skip("flat-state samplers by contract (d-dim vectors)")
    x0 = 0.5 * jax.random.normal(key, (6, 1, 4, 4))
    out = sampler.sample(jax.random.fold_in(key, 1), x=x0, n_steps=15)
    assert out.shape == x0.shape
    assert bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.parametrize("name,sampler,energy", _samplers(), ids=IDS)
def test_tuple_dim_init(name, sampler, energy, key):
    if name in ("nuts", "rmhmc"):
        shape = (2,)
    else:
        shape = (2, 3)
    out = sampler.sample(key, dim=shape, n_samples=4, n_steps=5)
    assert out.shape == (4, *shape)


@pytest.mark.parametrize("name,sampler,energy", _samplers(), ids=IDS)
def test_single_chain(name, sampler, energy, key):
    out = sampler.sample(key, dim=2, n_samples=1, n_steps=10)
    assert out.shape == (1, 2) and bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.parametrize("name,sampler,energy", _samplers(), ids=IDS)
def test_awkward_thin_divisor(name, sampler, energy, key):
    """n_steps=10, thin=3 keeps floor(10/3)=3 slots; the remainder steps
    still execute (final state differs from the last kept slot in general)."""
    traj, diag = sampler.sample(
        key, dim=2, n_samples=8, n_steps=10, thin=3,
        return_trajectory=True, return_diagnostics=True,
    )
    assert traj.shape == (8, 3, 2)
    for v in diag.values():
        assert v.shape[0] == 3
        assert bool(jnp.all(jnp.isfinite(v)))


@pytest.mark.parametrize("name,sampler,energy", _samplers(), ids=IDS)
def test_trajectory_final_slot_matches_plain_run(name, sampler, energy, key):
    """With thin=1 the last trajectory slot IS the returned final state of a
    plain run under the same key."""
    traj = sampler.sample(key, dim=2, n_samples=8, n_steps=12, return_trajectory=True)
    plain = sampler.sample(key, dim=2, n_samples=8, n_steps=12)
    assert traj.shape == (8, 12, 2)
    import numpy as np

    np.testing.assert_allclose(
        np.asarray(traj[:, -1]), np.asarray(plain), rtol=1e-5, atol=1e-6
    )


class TestGDFusedDispatch:
    """GradientDescentSampler rides the Langevin chain kernel at
    noise_scale=0 (an exact no-op term) on eager GPU calls."""

    def test_force_routes_and_matches_scan_exactly(self, monkeypatch, gpu_dispatch):
        import jax
        import jax.numpy as jnp
        import numpy as np

        import torchebm_tpu.ops.fused_langevin as fl
        from torchebm_tpu.core import GaussianMixtureEnergy
        from torchebm_tpu.samplers import GradientDescentSampler

        key = jax.random.PRNGKey(0)
        calls = []

        def stub(x0, means, n_steps, step_size, noise_scale, **kw):
            calls.append((x0.shape, noise_scale, kw.get("seed")))
            return x0

        monkeypatch.setattr(fl, "mixture_langevin_chain", stub)
        mix = GaussianMixtureEnergy.eight_gaussians(scale=0.4)
        gd = GradientDescentSampler(mix, step_size=0.05, fused="force")
        out = gd.sample(key, dim=2, n_samples=16, n_steps=4)
        assert calls == [((16, 2), 0.0, 0)]
        assert out.shape == (16, 2)

        # real-kernel equivalence in interpret mode: noise_scale=0 means the
        # in-kernel generator's contribution is exactly zero -> matches the scan
        monkeypatch.undo()
        x0 = mix.sample(key, 64)
        scan = GradientDescentSampler(mix, step_size=0.05, fused="off").sample(
            key, x=x0, n_steps=20
        )
        kernel = fl.mixture_langevin_chain(
            x0, mix.means, 20, 0.05, 0.0, scale=float(mix.scale),
            log_weights=mix.log_weights,
            noise=jnp.zeros((20, 64, 2)), interpret=True,
        )
        np.testing.assert_allclose(np.asarray(kernel), np.asarray(scan), atol=2e-5)

    def test_default_off_on_cpu(self, monkeypatch):
        import jax

        import torchebm_tpu.ops.fused_langevin as fl
        from torchebm_tpu.core import GaussianMixtureEnergy
        from torchebm_tpu.samplers import GradientDescentSampler

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("GD fused kernel called on CPU under 'auto'")

        monkeypatch.setattr(fl, "mixture_langevin_chain", boom)
        gd = GradientDescentSampler(GaussianMixtureEnergy.eight_gaussians(), step_size=0.05)
        assert gd.sample(jax.random.PRNGKey(0), dim=2, n_samples=8, n_steps=4).shape == (8, 2)
