"""Energy contract + analytic-energy correctness tests.

Modeled on the reference's numerics-first test strategy (SURVEY §4): analytic
formulas, autograd-vs-analytic gradient parity, known minima, exact-sampler
moment checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import (
    AckleyEnergy,
    DoubleWellEnergy,
    GaussianEnergy,
    GaussianMixtureEnergy,
    HarmonicEnergy,
    RastriginEnergy,
    RosenbrockEnergy,
    WrappedEnergy,
    as_energy,
)

ALL_ENERGIES = [
    DoubleWellEnergy(),
    GaussianEnergy.standard(4),
    GaussianMixtureEnergy.eight_gaussians(),
    HarmonicEnergy(),
    RosenbrockEnergy(),
    AckleyEnergy(),
    RastriginEnergy(),
]


@pytest.mark.parametrize("e", ALL_ENERGIES, ids=lambda e: type(e).__name__)
def test_energy_shape_contract(e, key):
    dim = 4 if not isinstance(e, GaussianMixtureEnergy) else 2
    x = jax.random.normal(key, (8, dim))
    out = e(x)
    assert out.shape == (8,)
    # 1D input promotes to singleton batch
    assert e(x[0]).shape == (1,)


@pytest.mark.parametrize("e", ALL_ENERGIES, ids=lambda e: type(e).__name__)
def test_gradient_matches_autodiff(e, key):
    dim = 4 if not isinstance(e, GaussianMixtureEnergy) else 2
    x = jax.random.normal(key, (8, dim))
    g_impl = e.gradient(x)
    g_auto = jax.grad(lambda xx: jnp.sum(e.energy(xx)))(x)
    np.testing.assert_allclose(g_impl, g_auto, rtol=1e-5, atol=1e-6)
    assert g_impl.shape == x.shape


@pytest.mark.parametrize("e", ALL_ENERGIES, ids=lambda e: type(e).__name__)
def test_score_is_negative_gradient(e, key):
    dim = 4 if not isinstance(e, GaussianMixtureEnergy) else 2
    x = jax.random.normal(key, (3, dim))
    np.testing.assert_allclose(e.score(x), -e.gradient(x), rtol=1e-6)


def test_gaussian_energy_values():
    mean = jnp.array([1.0, -1.0])
    cov = jnp.array([[2.0, 0.3], [0.3, 0.5]])
    e = GaussianEnergy.create(mean, cov)
    x = jnp.array([[1.0, -1.0]])  # at the mean: energy 0
    np.testing.assert_allclose(e(x), jnp.zeros(1), atol=1e-7)
    # quadratic form check against numpy
    x2 = jnp.array([[0.0, 0.0]])
    d = np.array([-1.0, 1.0])
    expected = 0.5 * d @ np.linalg.inv(np.asarray(cov)) @ d
    np.testing.assert_allclose(e(x2)[0], expected, rtol=1e-5)


def test_gaussian_create_validation():
    with pytest.raises(ValueError):
        GaussianEnergy.create(jnp.zeros((2, 2)), jnp.eye(2))
    with pytest.raises(ValueError):
        GaussianEnergy.create(jnp.zeros(3), jnp.eye(2))


def test_known_minima():
    # Double well minimum at ±b with energy 0
    dw = DoubleWellEnergy(barrier_height=2.0, b=1.0)
    np.testing.assert_allclose(dw(jnp.array([[1.0, -1.0]])), 0.0, atol=1e-6)
    # Harmonic at 0
    np.testing.assert_allclose(HarmonicEnergy(k=3.0)(jnp.zeros((1, 5))), 0.0)
    # Rosenbrock at (1, 1, ...)
    np.testing.assert_allclose(RosenbrockEnergy()(jnp.ones((1, 4))), 0.0, atol=1e-6)
    # Ackley global minimum 0 at origin
    np.testing.assert_allclose(AckleyEnergy()(jnp.zeros((1, 3))), 0.0, atol=1e-5)
    # Rastrigin 0 at origin
    np.testing.assert_allclose(RastriginEnergy()(jnp.zeros((1, 3))), 0.0, atol=1e-5)


def test_rosenbrock_requires_2d():
    with pytest.raises(ValueError):
        RosenbrockEnergy()(jnp.zeros((3, 1)))


def test_mixture_exact_sampler_moments(key):
    mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.4)
    samples = mix.sample(key, 40_000)
    # symmetric ring: mean ~ 0, E[|x|] ~ radius
    np.testing.assert_allclose(jnp.mean(samples, 0), jnp.zeros(2), atol=0.06)
    r = jnp.mean(jnp.linalg.norm(samples, axis=-1))
    assert abs(float(r) - 4.0) < 0.1


def test_mixture_single_component_is_gaussian(key):
    mix = GaussianMixtureEnergy.create(jnp.zeros((1, 3)), scale=1.0)
    g = GaussianEnergy.standard(3)
    x = jax.random.normal(key, (16, 3))
    # energies agree up to the normalization constant
    diff = mix(x) - g(x)
    np.testing.assert_allclose(diff, jnp.full_like(diff, diff[0]), atol=1e-5)
    np.testing.assert_allclose(mix.gradient(x), g.gradient(x), atol=1e-5)


def test_wrapped_energy_and_as_energy(key):
    x = jax.random.normal(key, (5, 2))
    e = as_energy(lambda xx: jnp.sum(xx**2, -1))
    assert isinstance(e, WrappedEnergy)
    np.testing.assert_allclose(e(x), jnp.sum(x**2, -1))
    # parameterized form: fn(params, x)
    e2 = as_energy(lambda p, xx: p * jnp.sum(xx**2, -1), params=jnp.float32(2.0))
    np.testing.assert_allclose(e2(x), 2 * jnp.sum(x**2, -1))
    # passes through jit as a pytree with params as leaf
    f = jax.jit(lambda en, xx: en(xx))
    np.testing.assert_allclose(f(e2, x), 2 * jnp.sum(x**2, -1))
    # already-an-energy passthrough
    assert as_energy(e2) is e2


def test_value_and_grad_consistent(key):
    e = DoubleWellEnergy()
    x = jax.random.normal(key, (6, 3))
    v, g = e.value_and_grad(x)
    np.testing.assert_allclose(v, e(x), rtol=1e-6)
    np.testing.assert_allclose(g, e.gradient(x), rtol=1e-6)


def test_energies_are_jit_stable(key):
    """Energies pass through jit as pytrees; param change does not recompile."""
    x = jax.random.normal(key, (4, 2))

    calls = 0

    @jax.jit
    def f(e, xx):
        nonlocal calls
        calls += 1
        return e(xx)

    e1 = GaussianEnergy.standard(2)
    e2 = GaussianEnergy.create(jnp.ones(2), 2.0 * jnp.eye(2))
    f(e1, x)
    f(e2, x)
    assert calls == 1  # traced once: params are leaves, not constants


