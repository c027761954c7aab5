"""Shared case builder for the whole-chain kernel matrix tests.

Each case runs the Triton-route kernel in interpret mode with injected noise
and compares it with :func:`torchebm_tpu.ops.reference_chain`, the plain
``jnp`` chain built on the energy's own ``gradient``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from torchebm_tpu.core import DoubleWellEnergy, GaussianEnergy, GaussianMixtureEnergy
from torchebm_tpu.ops import langevin_chain, reference_chain

N_CHAINS = 37  # not a multiple of the 32-chain block: exercises the padded tail


def tolerance(d: int) -> float:
    """Absolute tolerance on the state after ``N_STEPS`` steps. The kernel
    sums the d squared distances and the K mixture terms in another order
    than XLA (online softmax over components), so each step differs by a
    few float32 ulps of |x|·d; over 12 steps of a d=64, K=16 mixture that
    reaches ~3e-5. 1e-5 per 8 dimensions covers it."""
    return 1e-5 * max(1.0, d / 8)
N_STEPS = 12
CLAMPS = {"noclamp": None, "clamp": (-2.0, 2.0)}


def target_for(family: str, d: int, key):
    """``(energy, kernel target, means, log_weights)`` for one family."""
    if family == "doublewell":
        e = DoubleWellEnergy(barrier_height=1.5, b=0.8)
        return e, ("doublewell", 1.5, 0.8), None, None
    if family == "gaussian":
        mean = jax.random.normal(key, (d,))
        e = GaussianEnergy.create(mean, 1.7 * jnp.eye(d))
        return e, ("mixture", 1, 1.0 / 1.7), mean[None, :], jnp.zeros((1,))
    k = 16 if d == 64 else 4
    means = 2.0 * jax.random.normal(key, (k, d))
    w = jax.random.uniform(jax.random.fold_in(key, 1), (k,), minval=0.5, maxval=2.0)
    e = GaussianMixtureEnergy.create(means, scale=0.8, weights=w)
    return e, ("mixture", k, 1.0 / 0.64), means, e.log_weights


def run_case(family, d, schedule, output, clamp, seed=0):
    key = jax.random.PRNGKey(seed + 17 * d)
    energy, target, means, log_w = target_for(family, d, key)
    x0 = jax.random.normal(jax.random.fold_in(key, 2), (N_CHAINS, d))
    noise = jax.random.normal(jax.random.fold_in(key, 3), (N_STEPS, N_CHAINS, d))
    if schedule == "sched":
        h = jnp.linspace(0.03, 0.005, N_STEPS)
        ns = jnp.linspace(0.3, 1.0, N_STEPS)
    else:
        h, ns = 0.02, 0.9
    thin = 5 if output == "traj" else 0
    got = langevin_chain(
        x0, target, N_STEPS, h, ns, thin=thin, means=means, log_weights=log_w,
        clamp=clamp, noise=noise, interpret=True,
    )
    want = reference_chain(energy.gradient, x0, N_STEPS, h, ns, noise, clamp=clamp, thin=thin)
    if thin:
        assert got[0].shape == (N_STEPS // thin, N_CHAINS, d)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=tolerance(d))
        got, want = got[1], want[1]
    assert got.shape == (N_CHAINS, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tolerance(d))
    if clamp is not None:
        assert float(jnp.max(jnp.abs(got))) <= 2.0
