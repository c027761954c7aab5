"""Exact-parity tests for the whole-chain Langevin kernel.

The reference's correctness pattern (``torchebm/cuda/fused_langevin.py:90-138``:
same noise ⇒ max-abs-err vs the eager update): the injected-noise kernel runs
step for step against plain-jnp loops, here in interpret mode on the CPU
(compiled for the GPU on the card, where ``chip_smoke.py`` repeats the check
at full width).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.ops import doublewell_langevin_chain, mixture_langevin_chain
from torchebm_tpu.ops.fused_langevin import _from_rows, _to_rows


def _clip(x, clamp):
    return x if clamp is None else jnp.clip(x, clamp[0], clamp[1])


def _mix_grad_logp(x, means, logw, inv_var):
    """Plain-jnp mirror of the kernels' mixture math (same op order)."""
    k, d = means.shape
    logits = []
    for j in range(k):
        sq = None
        for i in range(d):
            diff = x[:, i] - means[j, i]
            sq = diff * diff if sq is None else sq + diff * diff
        logits.append(logw[j] - 0.5 * inv_var * sq)
    m = logits[0]
    for j in range(1, k):
        m = jnp.maximum(m, logits[j])
    nums = [jnp.zeros_like(x[:, 0]) for _ in range(d)]
    den = jnp.zeros_like(x[:, 0])
    for j in range(k):
        w = jnp.exp(logits[j] - m)
        den = den + w
        for i in range(d):
            nums[i] = nums[i] + w * means[j, i]
    inv_den = 1.0 / den
    grad = jnp.stack([(x[:, i] - nums[i] * inv_den) * inv_var for i in range(d)], -1)
    return grad, m + jnp.log(den)


# ---------------------------------------------------------------- double well


@pytest.mark.parametrize("clamp", [None, (-1.5, 1.5)])
def test_doublewell_chain_noise_parity(key, clamp):
    n_steps, shape = 17, (37, 3)  # non-aligned on purpose
    h, ns, bh, b = 0.01, 0.8, 2.0, 1.0
    x0 = jax.random.normal(key, shape)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_steps, *shape))

    out = doublewell_langevin_chain(
        x0, n_steps, h, ns, barrier_height=bh, b=b, clamp=clamp,
        noise=noise, interpret=True,
    )

    coef = ns * math.sqrt(2 * h)
    x = x0
    for t in range(n_steps):
        grad = 4.0 * bh * x * (x * x - b * b)
        x = _clip(x - h * grad + coef * noise[t], clamp)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)


@pytest.mark.parametrize("clamp", [None, (-1.5, 1.5)])
def test_doublewell_chain_scheduled_noise_parity(key, clamp):
    """Per-step (n_steps,) step/noise schedules ride the kernel's schedule
    table — parity vs a plain-jnp loop with the same per-step values."""
    n_steps, shape = 13, (29, 2)
    bh, b = 2.0, 1.0
    hs = jnp.linspace(0.02, 0.005, n_steps)
    nss = jnp.linspace(0.0, 1.0, n_steps)  # annealed-in noise (EM profile shape)
    x0 = jax.random.normal(key, shape)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_steps, *shape))

    out = doublewell_langevin_chain(
        x0, n_steps, hs, nss, barrier_height=bh, b=b, clamp=clamp,
        noise=noise, interpret=True,
    )

    x = x0
    for t in range(n_steps):
        grad = 4.0 * bh * x * (x * x - b * b)
        coef = nss[t] * jnp.sqrt(2.0 * hs[t])
        x = _clip(x - hs[t] * grad + coef * noise[t], clamp)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)


def test_doublewell_scheduled_constant_table_matches_constant_kernel(key):
    """Scalar step/noise and a constant-valued (n_steps,) schedule take the
    same table path and agree under the same injected noise."""
    n_steps, shape = 9, (24, 2)
    h, ns = 0.01, 0.8
    x0 = jax.random.normal(key, shape)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_steps, *shape))
    const = doublewell_langevin_chain(
        x0, n_steps, h, ns, noise=noise, interpret=True
    )
    sched = doublewell_langevin_chain(
        x0, n_steps, jnp.full((n_steps,), h), jnp.full((n_steps,), ns),
        noise=noise, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(sched), np.asarray(const), atol=1e-6)


def test_schedule_shape_guard(key):
    x0 = jax.random.normal(key, (8, 2))
    with pytest.raises(ValueError, match="per-step schedule"):
        doublewell_langevin_chain(
            x0, 5, jnp.ones((3,)), 1.0, interpret=True
        )


def test_doublewell_chain_noise_shape_guard(key):
    x0 = jax.random.normal(key, (8, 2))
    with pytest.raises(ValueError, match="noise must have shape"):
        doublewell_langevin_chain(
            x0, 5, 0.01, noise=jnp.zeros((4, 8, 2)), interpret=True
        )


# ------------------------------------------------------------------- mixture


@pytest.mark.parametrize("d,k,clamp", [(2, 8, None), (5, 4, None), (3, 3, (-6.0, 6.0))])
def test_mixture_chain_noise_parity(key, d, k, clamp):
    n, n_steps = 53, 11
    h, ns, scale = 0.05, 0.9, 0.7
    means = 3.0 * jax.random.normal(jax.random.fold_in(key, 2), (k, d))
    logw = jax.nn.log_softmax(jax.random.normal(jax.random.fold_in(key, 3), (k,)))
    x0 = jax.random.normal(key, (n, d))
    noise = jax.random.normal(jax.random.fold_in(key, 4), (n_steps, n, d))

    out = mixture_langevin_chain(
        x0, means, n_steps, h, ns, scale=scale, log_weights=logw,
        clamp=clamp, noise=noise, interpret=True,
    )

    coef = ns * math.sqrt(2 * h)
    inv_var = 1.0 / scale**2
    x = x0
    for t in range(n_steps):
        grad, _ = _mix_grad_logp(x, means, logw, inv_var)
        x = _clip(x - h * grad + coef * noise[t], clamp)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)


def test_mixture_chain_default_weights_parity(key):
    """log_weights=None means uniform — same as passing them explicitly."""
    means = jnp.array([[0.0, 2.0], [1.0, -1.0], [-2.0, 0.5]])
    x0 = jax.random.normal(key, (16, 2))
    noise = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, 2))
    a = mixture_langevin_chain(x0, means, 4, 0.05, noise=noise, interpret=True)
    b = mixture_langevin_chain(
        x0, means, 4, 0.05, log_weights=jnp.full((3,), -math.log(3)),
        noise=noise, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("d,k,clamp", [(2, 8, None), (3, 3, (-6.0, 6.0))])
def test_mixture_chain_scheduled_noise_parity(key, d, k, clamp):
    """Scheduled step/noise on the mixture chain kernel (the annealed
    Energy-Matching workload shape)."""
    n, n_steps = 47, 10
    scale = 0.7
    hs = jnp.linspace(0.08, 0.02, n_steps)
    nss = jnp.linspace(0.2, 1.0, n_steps)
    means = 3.0 * jax.random.normal(jax.random.fold_in(key, 2), (k, d))
    logw = jax.nn.log_softmax(jax.random.normal(jax.random.fold_in(key, 3), (k,)))
    x0 = jax.random.normal(key, (n, d))
    noise = jax.random.normal(jax.random.fold_in(key, 4), (n_steps, n, d))

    out = mixture_langevin_chain(
        x0, means, n_steps, hs, nss, scale=scale, log_weights=logw,
        clamp=clamp, noise=noise, interpret=True,
    )

    inv_var = 1.0 / scale**2
    x = x0
    for t in range(n_steps):
        grad, _ = _mix_grad_logp(x, means, logw, inv_var)
        coef = nss[t] * jnp.sqrt(2.0 * hs[t])
        x = _clip(x - hs[t] * grad + coef * noise[t], clamp)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)


@pytest.mark.parametrize("thin", [1, 3])
def test_doublewell_trajectory_noise_parity(key, thin):
    """Every thin-th state is stored to the trajectory from inside the loop;
    kept slots and the final state must match the plain-jnp loop exactly."""
    from torchebm_tpu.ops import doublewell_langevin_chain_trajectory

    n_steps, shape = 11, (21, 2)  # thin=3 -> 3 kept + 2 remainder steps
    h, ns, bh, b = 0.01, 0.8, 2.0, 1.0
    x0 = jax.random.normal(key, shape)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_steps, *shape))

    traj, final = doublewell_langevin_chain_trajectory(
        x0, n_steps, h, ns, thin=thin, barrier_height=bh, b=b,
        noise=noise, interpret=True,
    )

    coef = ns * math.sqrt(2 * h)
    x, kept = x0, []
    for t in range(n_steps):
        grad = 4.0 * bh * x * (x * x - b * b)
        x = x - h * grad + coef * noise[t]
        if (t + 1) % thin == 0:
            kept.append(x)
    assert traj.shape == (n_steps // thin, *shape)
    np.testing.assert_allclose(np.asarray(traj), np.asarray(jnp.stack(kept)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(final), np.asarray(x), atol=1e-5)


@pytest.mark.parametrize("d,k,thin", [(2, 8, 1), (3, 3, 4)])
def test_mixture_trajectory_noise_parity(key, d, k, thin):
    from torchebm_tpu.ops import mixture_langevin_chain_trajectory

    n, n_steps = 37, 9
    h, ns, scale = 0.05, 0.9, 0.7
    means = 3.0 * jax.random.normal(jax.random.fold_in(key, 2), (k, d))
    logw = jax.nn.log_softmax(jax.random.normal(jax.random.fold_in(key, 3), (k,)))
    x0 = jax.random.normal(key, (n, d))
    noise = jax.random.normal(jax.random.fold_in(key, 4), (n_steps, n, d))

    traj, final = mixture_langevin_chain_trajectory(
        x0, means, n_steps, h, ns, thin=thin, scale=scale, log_weights=logw,
        noise=noise, interpret=True,
    )

    coef = ns * math.sqrt(2 * h)
    inv_var = 1.0 / scale**2
    x, kept = x0, []
    for t in range(n_steps):
        grad, _ = _mix_grad_logp(x, means, logw, inv_var)
        x = x - h * grad + coef * noise[t]
        if (t + 1) % thin == 0:
            kept.append(x)
    assert traj.shape == (n_steps // thin, n, d)
    np.testing.assert_allclose(np.asarray(traj), np.asarray(jnp.stack(kept)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(final), np.asarray(x), atol=1e-5)


@pytest.mark.parametrize("thin", [1, 3])
def test_doublewell_sched_trajectory_noise_parity(key, thin):
    """The schedule table and the trajectory stores compose — an annealed
    chain with trajectory recording must match the plain-jnp loop at every
    kept slot."""
    from torchebm_tpu.ops import doublewell_langevin_chain_trajectory

    n_steps, shape = 11, (21, 2)
    bh, b = 2.0, 1.0
    hs = jnp.linspace(0.05, 0.01, n_steps)
    nss = jnp.linspace(0.2, 1.0, n_steps)
    x0 = jax.random.normal(key, shape)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_steps, *shape))

    traj, final = doublewell_langevin_chain_trajectory(
        x0, n_steps, hs, nss, thin=thin, barrier_height=bh, b=b,
        noise=noise, interpret=True,
    )

    x, kept = x0, []
    for t in range(n_steps):
        grad = 4.0 * bh * x * (x * x - b * b)
        x = x - hs[t] * grad + nss[t] * jnp.sqrt(2.0 * hs[t]) * noise[t]
        if (t + 1) % thin == 0:
            kept.append(x)
    assert traj.shape == (n_steps // thin, *shape)
    np.testing.assert_allclose(np.asarray(traj), np.asarray(jnp.stack(kept)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(final), np.asarray(x), atol=1e-5)


@pytest.mark.parametrize("d,k,thin", [(2, 4, 2)])
def test_mixture_sched_trajectory_noise_parity(key, d, k, thin):
    from torchebm_tpu.ops import mixture_langevin_chain_trajectory

    n, n_steps = 37, 9
    scale = 0.7
    hs = jnp.linspace(0.08, 0.02, n_steps)
    nss = jnp.linspace(0.0, 1.0, n_steps)  # TemperatureScheduler-like ramp
    means = 3.0 * jax.random.normal(jax.random.fold_in(key, 2), (k, d))
    logw = jax.nn.log_softmax(jax.random.normal(jax.random.fold_in(key, 3), (k,)))
    x0 = jax.random.normal(key, (n, d))
    noise = jax.random.normal(jax.random.fold_in(key, 4), (n_steps, n, d))

    traj, final = mixture_langevin_chain_trajectory(
        x0, means, n_steps, hs, nss, thin=thin, scale=scale, log_weights=logw,
        noise=noise, interpret=True,
    )

    inv_var = 1.0 / scale**2
    x, kept = x0, []
    for t in range(n_steps):
        grad, _ = _mix_grad_logp(x, means, logw, inv_var)
        x = x - hs[t] * grad + nss[t] * jnp.sqrt(2.0 * hs[t]) * noise[t]
        if (t + 1) % thin == 0:
            kept.append(x)
    assert traj.shape == (n_steps // thin, n, d)
    np.testing.assert_allclose(np.asarray(traj), np.asarray(jnp.stack(kept)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(final), np.asarray(x), atol=1e-5)


def test_trajectory_thin_guard(key):
    from torchebm_tpu.ops import doublewell_langevin_chain_trajectory

    with pytest.raises(ValueError, match="thin"):
        doublewell_langevin_chain_trajectory(
            jnp.zeros((8, 2)), 5, 0.01, thin=0, interpret=True
        )
    with pytest.raises(ValueError, match="n_steps // thin"):
        doublewell_langevin_chain_trajectory(
            jnp.zeros((8, 2)), 3, 0.01, thin=5, interpret=True
        )


def test_mixture_chain_size_guard(key):
    means = jnp.zeros((64, 32))  # K*d = 2048 > 1024
    with pytest.raises(ValueError, match="K\\*d"):
        mixture_langevin_chain(jnp.zeros((8, 32)), means, 3, 0.01, interpret=True)


def test_tiles_round_trip(key):
    """Chain-major (n, d) <-> the kernel's coordinate-major (2H, n_pad)."""
    x = jax.random.normal(key, (1234, 7))
    t = _to_rows(x, 7, 1280)
    assert t.shape == (8, 1280)  # h = 4 rows per half, H = 4
    np.testing.assert_array_equal(np.asarray(t[:4, :1234]), np.asarray(x[:, :4].T))
    np.testing.assert_array_equal(np.asarray(t[4:7, :1234]), np.asarray(x[:, 4:].T))
    assert not np.any(np.asarray(t[7])) and not np.any(np.asarray(t[:, 1234:]))
    np.testing.assert_array_equal(np.asarray(_from_rows(t, 7, 1234)), np.asarray(x))


# ----------------------------------------------- full-covariance Gaussian


@pytest.mark.parametrize("d", [2, 4])
def test_gaussian_langevin_chain_noise_parity(key, d):
    """An isotropic Gaussian runs as a one-component mixture (the sampler's
    GaussianEnergy row): grad = (x - mu) / sigma^2."""
    n, n_steps = 41, 9
    h, ns, sigma = 0.05, 0.9, 1.3
    mean = jax.random.normal(jax.random.fold_in(key, 2), (d,))
    x0 = jax.random.normal(key, (n, d))
    noise = jax.random.normal(jax.random.fold_in(key, 4), (n_steps, n, d))

    out = mixture_langevin_chain(
        x0, mean[None, :], n_steps, h, ns, scale=sigma,
        noise=noise, interpret=True,
    )

    coef = ns * math.sqrt(2 * h)
    x = x0
    for t in range(n_steps):
        x = x - h * (x - mean) / sigma**2 + coef * noise[t]
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)
