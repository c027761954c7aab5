"""Langevin dynamics statistical + behavioral tests.

Mirrors ``tests/samplers/test_langevin_dynamics.py`` (moment matching against
analytic Gaussian energies is the reference's key statistical test, :184).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import (
    CosineScheduler,
    DoubleWellEnergy,
    GaussianEnergy,
    GaussianMixtureEnergy,
)
from torchebm_tpu.samplers import LangevinDynamics


@pytest.mark.slow
def test_gaussian_sampling_statistics(key):
    mean = jnp.array([1.0, -1.0])
    cov = jnp.array([[1.0, 0.3], [0.3, 0.5]])
    sampler = LangevinDynamics(GaussianEnergy.create(mean, cov), step_size=0.01)
    samples = sampler.sample(key, dim=2, n_samples=5000, n_steps=2000)
    np.testing.assert_allclose(jnp.mean(samples, 0), mean, atol=0.08)
    np.testing.assert_allclose(jnp.cov(samples.T), cov, atol=0.1)


def test_double_well_modes(key):
    sampler = LangevinDynamics(DoubleWellEnergy(barrier_height=2.0), step_size=0.01)
    samples = sampler.sample(key, dim=1, n_samples=2000, n_steps=1000)
    # symmetric double well: |x| concentrates near 1
    assert abs(float(jnp.mean(jnp.abs(samples))) - 1.0) < 0.15


def test_mixture_modes_covered(key):
    mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.4)
    sampler = LangevinDynamics(mix, step_size=0.05)
    x0 = mix.sample(key, 4000)  # start at equilibrium; Langevin should stay there
    samples = sampler.sample(jax.random.fold_in(key, 1), x=x0, n_steps=500)
    r = jnp.linalg.norm(samples, axis=-1)
    assert abs(float(jnp.mean(r)) - 4.0) < 0.2


def test_same_key_reproduces(key):
    sampler = LangevinDynamics(GaussianEnergy.standard(2), step_size=0.01)
    a = sampler.sample(key, dim=2, n_samples=16, n_steps=50)
    b = sampler.sample(key, dim=2, n_samples=16, n_steps=50)
    np.testing.assert_array_equal(a, b)
    c = sampler.sample(jax.random.fold_in(key, 1), dim=2, n_samples=16, n_steps=50)
    assert float(jnp.max(jnp.abs(a - c))) > 1e-4


def test_clamp(key):
    sampler = LangevinDynamics(
        GaussianEnergy.standard(2), step_size=0.1, noise_scale=5.0, clamp=(-1.0, 1.0)
    )
    out = sampler.sample(key, dim=2, n_samples=64, n_steps=20)
    assert float(jnp.max(jnp.abs(out))) <= 1.0
    with pytest.raises(ValueError):
        LangevinDynamics(GaussianEnergy.standard(2), clamp=(1.0, -1.0))


def test_scheduled_step_size_runs(key):
    sch = CosineScheduler(0.05, 0.001, 100)
    sampler = LangevinDynamics(GaussianEnergy.standard(2), step_size=sch)
    out = sampler.sample(key, dim=2, n_samples=8, n_steps=100)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_zero_noise_is_gradient_descent(key):
    e = GaussianEnergy.standard(2)
    sampler = LangevinDynamics(e, step_size=0.1, noise_scale=0.0)
    x0 = jnp.full((4, 2), 3.0)
    out = sampler.sample(key, x=x0, n_steps=1)
    np.testing.assert_allclose(out, x0 - 0.1 * e.gradient(x0), rtol=1e-5)


def test_alternative_sde_integrator(key):
    sampler = LangevinDynamics(GaussianEnergy.standard(2), step_size=0.01, integrator="heun")
    out = sampler.sample(key, dim=2, n_samples=128, n_steps=500)
    assert abs(float(jnp.var(out)) - 1.0) < 0.3


class TestFusedDispatch:
    """Eager GPU calls route to the whole-chain kernel. Here the backend
    predicate answers as on a GPU (``gpu_dispatch``) and the kernel is
    stubbed or interpreted; the compiled kernel runs in the ``gpu`` tests."""

    def test_force_routes_doublewell(self, key, monkeypatch, gpu_dispatch):
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, n_steps, step_size, noise_scale, *, barrier_height, b, seed,
                 clamp=None, interpret=False):
            calls.append((x0.shape, n_steps, step_size, noise_scale, barrier_height, b))
            return x0

        monkeypatch.setattr(fl, "doublewell_langevin_chain", stub)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01, fused="force")
        out = sampler.sample(key, dim=4, n_samples=32, n_steps=7)
        assert calls == [((32, 4), 7, 0.01, 1.0, 2.0, 1.0)]
        assert out.shape == (32, 4)

    def test_force_routes_mixture(self, key, monkeypatch, gpu_dispatch):
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, means, n_steps, step_size, noise_scale, *, scale, log_weights,
                 seed, clamp=None, interpret=False):
            calls.append((x0.shape, means.shape, n_steps, scale))
            return x0

        monkeypatch.setattr(fl, "mixture_langevin_chain", stub)
        mix = GaussianMixtureEnergy.eight_gaussians(scale=0.4)
        sampler = LangevinDynamics(mix, step_size=0.05, fused="force")
        out = sampler.sample(key, dim=2, n_samples=64, n_steps=5)
        assert calls == [((64, 2), (8, 2), 5, pytest.approx(0.4))]
        assert out.shape == (64, 2)

    def test_force_routes_ddim_mixture(self, key, monkeypatch, gpu_dispatch):
        """d>2 mixtures dispatch to the kernel too."""
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, means, n_steps, step_size, noise_scale, **kw):
            calls.append((x0.shape, means.shape))
            return x0

        monkeypatch.setattr(fl, "mixture_langevin_chain", stub)
        means = jax.random.normal(key, (4, 5))
        mix = GaussianMixtureEnergy.create(means, scale=0.7)
        sampler = LangevinDynamics(mix, step_size=0.05, fused="force")
        out = sampler.sample(key, dim=5, n_samples=16, n_steps=3)
        assert calls == [((16, 5), (4, 5))]
        assert out.shape == (16, 5)

    def test_force_routes_isotropic_gaussian(self, key, monkeypatch, gpu_dispatch):
        """Isotropic GaussianEnergy routes as a 1-component mixture."""
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, means, n_steps, step_size, noise_scale, *, scale, **kw):
            calls.append((x0.shape, means.shape, scale))
            return x0

        monkeypatch.setattr(fl, "mixture_langevin_chain", stub)
        e = GaussianEnergy.create(jnp.array([1.0, 2.0, 3.0]), 4.0 * jnp.eye(3))
        sampler = LangevinDynamics(e, step_size=0.05, fused="force")
        out = sampler.sample(key, dim=3, n_samples=16, n_steps=3)
        assert calls == [((16, 3), (1, 3), pytest.approx(2.0))]
        assert out.shape == (16, 3)

    def test_anisotropic_gaussian_routes_with_precision(self, key, monkeypatch, gpu_dispatch):
        """Full-covariance Gaussians run on the compiled scan (the kernel
        takes isotropic targets only); ``fused="force"`` refuses them."""
        import torchebm_tpu.ops.fused_langevin as fl

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("a full-covariance Gaussian must use the scan path")

        monkeypatch.setattr(fl, "mixture_langevin_chain", boom)
        cov = jnp.array([[2.0, 0.5], [0.5, 1.0]])
        e = GaussianEnergy.create(jnp.zeros(2), cov)
        out = LangevinDynamics(e, step_size=0.05).sample(key, dim=2, n_samples=8, n_steps=3)
        assert out.shape == (8, 2)
        with pytest.raises(ValueError, match="force"):
            LangevinDynamics(e, step_size=0.05, fused="force").sample(
                key, dim=2, n_samples=8, n_steps=3
            )

    def test_oversize_gaussian_falls_back(self, key, monkeypatch, gpu_dispatch):
        """Full-covariance Gaussians use the scan."""
        import torchebm_tpu.ops.fused_langevin as fl

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("d=40 Gaussian must use the scan path")

        monkeypatch.setattr(fl, "mixture_langevin_chain", boom)
        d = 40
        a = jax.random.normal(key, (d, d)) / jnp.sqrt(d)
        e = GaussianEnergy.create(jnp.zeros(d), a @ a.T + jnp.eye(d))
        sampler = LangevinDynamics(e, step_size=0.05)
        assert sampler.sample(key, dim=d, n_samples=8, n_steps=2).shape == (8, d)

    def test_oversize_mixture_falls_back(self, key, monkeypatch, gpu_dispatch):
        """K*d beyond the kernel's cap uses the scan path; force refuses."""
        import torchebm_tpu.ops.fused_langevin as fl

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("oversize mixture must use the scan path")

        monkeypatch.setattr(fl, "mixture_langevin_chain", boom)
        means = jax.random.normal(key, (64, 32))  # K*d = 2048 > 1024
        mix = GaussianMixtureEnergy.create(means)
        sampler = LangevinDynamics(mix, step_size=0.01)
        assert sampler.sample(key, dim=32, n_samples=8, n_steps=2).shape == (8, 32)
        with pytest.raises(ValueError, match="force"):
            sampler.replace(fused="force").sample(key, dim=32, n_samples=8, n_steps=2)

    def test_default_off_on_cpu(self, key, monkeypatch):
        """Default 'auto' never dispatches off-GPU — the scan path runs."""
        import torchebm_tpu.ops.fused_langevin as fl

        def boom(*a, **k):  # pragma: no cover - must not be reached
            raise AssertionError("fused kernel called on CPU under 'auto'")

        monkeypatch.setattr(fl, "doublewell_langevin_chain", boom)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)
        out = sampler.sample(key, dim=2, n_samples=16, n_steps=10)
        assert out.shape == (16, 2)

    def test_diagnostics_route_to_trajectory_kernel(self, key, monkeypatch, gpu_dispatch):
        """return_diagnostics rides the trajectory kernel too — the diag
        channel (mean/var/energy per kept slot, scan-loop contract) is
        computed from the kernel trajectory."""
        import torchebm_tpu.ops.fused_langevin as fl

        recorded = {}

        def stub(x0, n_steps, step_size, noise_scale, *, thin, **kw):
            n_kept = n_steps // thin
            traj = jnp.arange(n_kept * x0.size, dtype=jnp.float32).reshape(
                n_kept, *x0.shape
            )
            recorded["traj"] = traj
            return traj, x0 + 1.0

        monkeypatch.setattr(fl, "doublewell_langevin_chain_trajectory", stub)
        model = DoubleWellEnergy()
        sampler = LangevinDynamics(model, step_size=0.01, fused="force")
        out, diag = sampler.sample(
            key, dim=3, n_samples=8, n_steps=6, thin=2, return_diagnostics=True
        )
        traj = recorded["traj"]
        assert out.shape == (8, 3)  # final state, not the trajectory
        assert diag["mean"].shape == (3, 3) and diag["var"].shape == (3, 3)
        assert diag["energy"].shape == (3,)
        np.testing.assert_allclose(diag["mean"], jnp.mean(traj, axis=1), rtol=1e-6)
        np.testing.assert_allclose(
            diag["energy"],
            jnp.stack([jnp.mean(model.energy(traj[i])) for i in range(3)]),
            rtol=1e-6,
        )

    def test_trajectory_and_diagnostics_together(self, key, monkeypatch, gpu_dispatch):
        import torchebm_tpu.ops.fused_langevin as fl

        def stub(x0, n_steps, step_size, noise_scale, *, thin, **kw):
            n_kept = n_steps // thin
            return jnp.zeros((n_kept, *x0.shape)), x0

        monkeypatch.setattr(fl, "doublewell_langevin_chain_trajectory", stub)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01, fused="force")
        out, diag = sampler.sample(
            key, dim=2, n_samples=4, n_steps=4, thin=2,
            return_trajectory=True, return_diagnostics=True,
        )
        assert out.shape == (4, 2, 2)
        assert diag["energy"].shape == (2,)

    def test_trajectory_routes_to_trajectory_kernel(self, key, monkeypatch, gpu_dispatch):
        """return_trajectory rides the trajectory kernel (parity pinned in
        tests/ops/test_chain_parity.py)."""
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, n_steps, step_size, noise_scale, *, thin, **kw):
            calls.append((x0.shape, n_steps, thin))
            n_kept = n_steps // thin
            return jnp.zeros((n_kept, *x0.shape)), x0

        monkeypatch.setattr(fl, "doublewell_langevin_chain_trajectory", stub)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01, fused="force")
        out = sampler.sample(
            key, dim=4, n_samples=16, n_steps=9, thin=3, return_trajectory=True
        )
        assert calls == [((16, 4), 9, 3)]
        assert out.shape == (16, 3, 4)

    def test_scheduled_trajectory_dispatches_fused(self, key, monkeypatch, gpu_dispatch):
        """Scheduled step/noise + trajectory rides the trajectory kernel with
        the concrete (n_steps,) schedule table forwarded (parity pinned in
        tests/ops/test_chain_parity.py::test_*_sched_trajectory_*)."""
        import torchebm_tpu.ops.fused_langevin as fl

        calls = []

        def stub(x0, n_steps, step_size, noise_scale, *, thin, **kw):
            calls.append((x0.shape, jnp.shape(step_size), noise_scale, thin))
            return jnp.zeros((n_steps // thin, *x0.shape)), x0

        monkeypatch.setattr(fl, "doublewell_langevin_chain_trajectory", stub)
        sched = CosineScheduler(0.02, 0.005, 10)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=sched, fused="force")
        out = sampler.sample(key, dim=2, n_samples=8, n_steps=10, return_trajectory=True)
        assert calls == [((8, 2), (10,), 1.0, 1)]
        assert out.shape == (8, 10, 2)

    def test_outer_jit_matches_eager_scan_bitwise(self, key, gpu_dispatch):
        """sample() under an OUTER jit must produce the exact scan-path chain
        — the tracer-bail at _fusable is load-bearing. Same key, dispatch on
        inside jit vs fused='off' eager: the identical RNG stream and update
        sequence, so trajectories and diagnostics agree to float-fusion
        rounding (XLA fuses differently under one jit)."""
        mix = GaussianMixtureEnergy.eight_gaussians(scale=0.4)
        forced = LangevinDynamics(mix, step_size=0.05, fused="auto")
        off = LangevinDynamics(mix, step_size=0.05, fused="off")

        @jax.jit
        def run(k):
            return forced.sample(
                k, dim=2, n_samples=64, n_steps=30, thin=3,
                return_trajectory=True, return_diagnostics=True,
            )

        traj_jit, diag_jit = run(key)
        traj_scan, diag_scan = off.sample(
            key, dim=2, n_samples=64, n_steps=30, thin=3,
            return_trajectory=True, return_diagnostics=True,
        )
        np.testing.assert_allclose(
            np.asarray(traj_jit), np.asarray(traj_scan), rtol=1e-5, atol=1e-5
        )
        for k_ in diag_scan:
            np.testing.assert_allclose(
                np.asarray(diag_jit[k_]), np.asarray(diag_scan[k_]),
                rtol=1e-4, atol=1e-5,
            )
        # and the chain is statistically sane: mixture is centered at 0
        assert abs(float(jnp.mean(traj_jit))) < 1.0

    def test_traced_calls_fall_back(self, key, monkeypatch, gpu_dispatch):
        """Inside user jit the generic scan path is used (shards/traces fine)."""
        import torchebm_tpu.ops.fused_langevin as fl

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("fused kernel must not be called under trace")

        monkeypatch.setattr(fl, "doublewell_langevin_chain", boom)
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)

        @jax.jit
        def run(k):
            return sampler.sample(k, dim=2, n_samples=8, n_steps=5)

        assert run(key).shape == (8, 2)

    def test_sharded_state_stays_on_scan(self, key, monkeypatch, gpu_dispatch):
        """A mesh-sharded x has no kernel partitioning: the scan runs it."""
        import torchebm_tpu.ops.fused_langevin as fl
        from torchebm_tpu.parallel import make_mesh, shard_batch

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("sharded chains must use the scan path")

        monkeypatch.setattr(fl, "doublewell_langevin_chain", boom)
        x = shard_batch(jax.random.normal(key, (16, 2)), make_mesh(("data",)))
        out = LangevinDynamics(DoubleWellEnergy(), step_size=0.01).sample(key, x=x, n_steps=3)
        assert out.shape == (16, 2)

    def test_invalid_flag_raises(self):
        with pytest.raises(ValueError, match="fused"):
            LangevinDynamics(DoubleWellEnergy(), fused="yes")

    def test_fused_clamp_forwarded(self, key, monkeypatch, gpu_dispatch):
        """clamp does not block dispatch — it is folded into the chain
        kernel (in-kernel clamp parity is pinned by tests/ops)."""
        import torchebm_tpu.ops.fused_langevin as fl

        seen = []

        def stub(x0, n_steps, step_size, noise_scale, *, clamp=None, **kw):
            seen.append(clamp)
            return x0

        monkeypatch.setattr(fl, "doublewell_langevin_chain", stub)
        sampler = LangevinDynamics(
            DoubleWellEnergy(), step_size=0.1, clamp=(-0.5, 0.5), fused="force"
        )
        sampler.sample(key, dim=2, n_samples=8, n_steps=5)
        assert seen == [(-0.5, 0.5)]

    def test_scheduled_params_dispatch_with_tables(self, key, monkeypatch, gpu_dispatch):
        """Scheduler step/noise does not block dispatch — the concrete
        (n_steps,) value tables are forwarded to the kernel (in-kernel parity
        is pinned by tests/ops)."""
        import torchebm_tpu.ops.fused_langevin as fl
        from torchebm_tpu.core import TemperatureScheduler

        seen = []

        def stub(x0, means, n_steps, step_size, noise_scale, **kw):
            seen.append((step_size, noise_scale))
            return x0

        monkeypatch.setattr(fl, "mixture_langevin_chain", stub)
        mix = GaussianMixtureEnergy.eight_gaussians()
        temp = TemperatureScheduler(epsilon_max=0.25, tau_star=0.5, n_steps=12)
        sampler = LangevinDynamics(
            mix, step_size=CosineScheduler(0.05, 0.01, 12), noise_scale=temp,
            fused="force",
        )
        out = sampler.sample(key, dim=2, n_samples=16, n_steps=12)
        assert out.shape == (16, 2)
        (ss, ns), = seen
        np.testing.assert_allclose(
            ss, jax.vmap(CosineScheduler(0.05, 0.01, 12).value)(jnp.arange(12)),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            ns, jax.vmap(temp.value)(jnp.arange(12)), rtol=1e-6
        )

    @pytest.mark.gpu
    def test_scheduled_fused_end_to_end(self, key, gpu):
        """The compiled kernel's annealed chain on the mixture energy ends up
        finite and near the modes (exact parity is pinned by the injected-noise
        tests in tests/ops/test_chain_parity.py)."""
        mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.4)
        sampler = LangevinDynamics(
            mix, step_size=0.05, noise_scale=CosineScheduler(1.0, 0.2, 30),
            fused="force",
        )
        x0 = mix.sample(key, 256)
        out = sampler.sample(jax.random.fold_in(key, 1), x=x0, n_steps=30)
        assert out.shape == (256, 2)
        assert bool(jnp.all(jnp.isfinite(out)))
        r = jnp.linalg.norm(out, axis=-1)
        assert abs(float(jnp.mean(r)) - 4.0) < 0.5

    @pytest.mark.parametrize("fused", ["force", "auto"])
    def test_force_raises_off_gpu(self, key, fused):
        """On the CPU 'force' is an error (the kernel compiles only for a
        GPU); 'auto' quietly takes the scan."""
        sampler = LangevinDynamics(DoubleWellEnergy(), step_size=0.01, fused=fused)
        if fused == "force":
            with pytest.raises(RuntimeError, match="GPU"):
                sampler.sample(key, dim=2, n_samples=8, n_steps=3)
        else:
            assert sampler.sample(key, dim=2, n_samples=8, n_steps=3).shape == (8, 2)

    @pytest.mark.parametrize("output", ["chain", "traj"])
    @pytest.mark.parametrize("family", ["doublewell", "gaussian", "mixture"])
    def test_dispatch_runs_kernel_end_to_end(self, key, family, output, gpu_dispatch,
                                             interpret_kernels):
        """The real kernel (interpreted) behind the sampler: the dispatched
        result equals a direct kernel call with the sampler's seed and x0."""
        import torchebm_tpu.ops.fused_langevin as fl

        model = {
            "doublewell": DoubleWellEnergy(),
            "gaussian": GaussianEnergy.create(jnp.array([1.0, -1.0, 0.5]), 0.5 * jnp.eye(3)),
            "mixture": GaussianMixtureEnergy.create(jnp.eye(3) * 2.0, scale=0.6),
        }[family]
        sampler = LangevinDynamics(model, step_size=0.02, clamp=(-3.0, 3.0))
        traj = output == "traj"
        out = sampler.sample(key, dim=3, n_samples=40, n_steps=6, thin=2, return_trajectory=traj)
        key_init, key_run = jax.random.split(key)
        x0 = sampler._init_state(key_init, None, 3, 40)
        seed = jax.random.randint(key_run, (), 0, jnp.iinfo(jnp.int32).max)
        kw = dict(seed=seed, clamp=(-3.0, 3.0))
        if family == "doublewell":
            want = fl.doublewell_langevin_chain_trajectory(x0, 6, 0.02, 1.0, thin=2, **kw)
        elif family == "gaussian":
            want = fl.mixture_langevin_chain_trajectory(
                x0, model.mean[None, :], 6, 0.02, 1.0, thin=2, scale=0.5**0.5, **kw
            )
        else:
            want = fl.mixture_langevin_chain_trajectory(
                x0, model.means, 6, 0.02, 1.0, thin=2, scale=0.6,
                log_weights=model.log_weights, **kw
            )
        if traj:
            np.testing.assert_allclose(out, jnp.moveaxis(want[0], 0, 1), atol=1e-6)
        else:
            np.testing.assert_allclose(out, want[1], atol=1e-6)

    def test_scan_path_still_clamped(self, key):
        sampler = LangevinDynamics(
            DoubleWellEnergy(), step_size=0.1, clamp=(-0.5, 0.5), fused="off"
        )
        out = sampler.sample(key, dim=2, n_samples=8, n_steps=5)
        assert float(jnp.max(jnp.abs(out))) <= 0.5


def test_no_recompile_on_param_change(key):
    """Changing step_size (a leaf) must not retrace the compiled chain."""
    e = GaussianEnergy.standard(2)
    s1 = LangevinDynamics(e, step_size=0.01)
    s2 = LangevinDynamics(e, step_size=0.02)
    from torchebm_tpu.samplers.base import _sample_impl

    s1.sample(key, dim=2, n_samples=4, n_steps=3)
    misses_before = _sample_impl._cache_size()
    s2.sample(key, dim=2, n_samples=4, n_steps=3)
    assert _sample_impl._cache_size() == misses_before
