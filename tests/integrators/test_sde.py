r"""SDE integrator tests: OU stationary statistics, key reproducibility, implicit stability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.integrators import (
    BackwardEulerMaruyamaIntegrator,
    EulerMaruyamaIntegrator,
    HeunIntegrator,
    get_integrator,
)


@pytest.mark.parametrize("name", ["euler", "heun", "backward_euler"])
def test_ou_stationary_variance(name, key):
    r"""OU process :math:`dx = -x\,dt + \sqrt{2}\,dW` has stationary var 1."""
    integ = get_integrator(name)
    x0 = jax.random.normal(key, (4096, 2))
    out = integ.integrate(
        {"x": x0}, 0.01, 2000, drift=lambda x, t: -x, key=jax.random.fold_in(key, 1),
        noise_scale=1.0,
    )
    var = float(jnp.var(out["x"]))
    assert abs(var - 1.0) < 0.08, var


def test_same_key_reproduces(key):
    integ = EulerMaruyamaIntegrator()
    x0 = jnp.ones((64, 2))
    a = integ.integrate({"x": x0}, 0.01, 50, drift=lambda x, t: -x, key=key)
    b = integ.integrate({"x": x0}, 0.01, 50, drift=lambda x, t: -x, key=key)
    np.testing.assert_array_equal(a["x"], b["x"])
    c = integ.integrate({"x": x0}, 0.01, 50, drift=lambda x, t: -x, key=jax.random.fold_in(key, 7))
    assert float(jnp.max(jnp.abs(a["x"] - c["x"]))) > 1e-4


def test_injected_noise_exact_parity(key):
    """`noise=` bypasses the internal RNG — exact-parity hook used by exact-parity tests."""
    integ = EulerMaruyamaIntegrator()
    x = jax.random.normal(key, (8, 2))
    eps = jax.random.normal(jax.random.fold_in(key, 1), (8, 2))
    h, ns = 0.01, 0.7
    out = integ.step({"x": x}, h, drift=lambda x, t: -x, noise=eps, noise_scale=ns)
    expected = x - h * x + ns * np.sqrt(2 * h) * eps
    np.testing.assert_allclose(out["x"], expected, rtol=1e-6)


def test_diffusion_overrides_noise_scale(key):
    integ = EulerMaruyamaIntegrator()
    x = jnp.zeros((4, 2))
    eps = jnp.ones((4, 2))
    out = integ.step({"x": x}, 0.01, drift=lambda x, t: jnp.zeros_like(x), noise=eps, diffusion=4.0)
    np.testing.assert_allclose(out["x"], np.sqrt(2 * 4.0 * 0.01), rtol=1e-6)


def test_backward_euler_implicit_damping(key):
    r"""Drift-implicit Euler damps by :math:`1/(1+h\lambda)` per step.

    The Picard fixed-point solve contracts only for :math:`|h\lambda| < 1`
    (same restriction as the reference's Picard solver,
    ``base_integrator.py:349-385``), so :math:`h\lambda = 0.5` is used and the
    implicit per-step factor 1/1.5 is checked against the explicit 0.5.
    """
    x0 = jnp.ones((4, 1))
    drift = lambda x, t: -50.0 * x
    n, h = 20, 0.01
    be = BackwardEulerMaruyamaIntegrator(solver_max_iter=50)
    out = be.integrate({"x": x0}, h, n, drift=drift, key=key, noise_scale=0.0)
    np.testing.assert_allclose(out["x"], (1.0 / 1.5) ** n, rtol=1e-4)
    fe = EulerMaruyamaIntegrator()
    out_fe = fe.integrate({"x": x0}, h, n, drift=drift, key=key, noise_scale=0.0)
    np.testing.assert_allclose(out_fe["x"], 0.5**n, rtol=1e-4)


def test_sde_requires_key():
    integ = EulerMaruyamaIntegrator()
    with pytest.raises(ValueError):
        integ.step({"x": jnp.ones((2, 2))}, 0.01, drift=lambda x, t: -x)
    with pytest.raises(ValueError):
        integ.integrate({"x": jnp.ones((2, 2))}, 0.01, 10, drift=lambda x, t: -x)


def test_picard_residual_mode_matches_fixed(key):
    be_fixed = BackwardEulerMaruyamaIntegrator(solver_max_iter=30)
    be_check = BackwardEulerMaruyamaIntegrator(solver_max_iter=30, solver_tol=1e-12, solver_check_every=1)
    x0 = jnp.ones((4, 2))
    a = be_fixed.integrate({"x": x0}, 0.05, 20, drift=lambda x, t: -x, key=key, noise_scale=0.0)
    b = be_check.integrate({"x": x0}, 0.05, 20, drift=lambda x, t: -x, key=key, noise_scale=0.0)
    np.testing.assert_allclose(a["x"], b["x"], rtol=1e-5)
