r"""Annealed importance sampling: log-partition-function estimation for EBMs.

Build addition beyond the reference (TorchEBM has no normalizing-constant
machinery): Neal (2001) AIS along a geometric path of intermediate densities

.. math::
    f_\beta(x) \propto e^{-(1-\beta)U_0(x) - \beta U_1(x)},
    \qquad 0 = \beta_0 < \dots < \beta_K = 1,

with one MALA transition (exact invariance at every rung, see
:mod:`torchebm_tpu.samplers.mala`) per temperature. Starting from exact
draws of the tractable base :math:`U_0` (default: standard Gaussian,
``GaussianEnergy.log_z()`` exact), the importance weights satisfy
:math:`E[w] = Z_1/Z_0`, so

.. math::
    \widehat{\log Z_1} = \log Z_0 + \operatorname{logsumexp}(\log w)-\log n.

The whole anneal — weight accumulation and MCMC transitions for every chain
and rung — compiles to one ``lax.scan``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy, GaussianEnergy

Array = jax.Array

__all__ = ["AISResult", "annealed_importance_sampling"]


@struct.dataclass
class AISResult:
    """AIS output: final samples, per-chain log-weights, log-Z estimates."""

    samples: Array  # (n_samples, d) — approximate target draws (weighted)
    log_weights: Array  # (n_samples,)
    log_z: Array  # scalar: estimate of log Z_target (absolute)
    log_z_ratio: Array  # scalar: log(Z_target / Z_base)
    ess: Array  # scalar: importance-weight effective sample size
    acceptance_rate: Array  # scalar: mean MALA acceptance over all rungs


@partial(jax.jit, static_argnames=("n_samples", "n_transitions"))
def _ais_impl(target, base, key, betas, step_size, n_samples, n_transitions):
    k_init, k_run = jax.random.split(key)
    x0 = base.sample(k_init, n_samples)

    def annealed(x, beta):
        return (1.0 - beta) * base.energy(x) + beta * target.energy(x)

    def annealed_grad(x, beta):
        return (1.0 - beta) * base.gradient(x) + beta * target.gradient(x)

    def mala_step(x, key, beta, eta):
        k_prop, k_acc = jax.random.split(key)
        g_x = annealed_grad(x, beta)
        eps = jax.random.normal(k_prop, x.shape, x.dtype)
        y = x - eta * g_x + jnp.sqrt(2.0 * eta) * eps
        g_y = annealed_grad(y, beta)

        def log_q(b, a, g_a):
            diff = b - a + eta * g_a
            return -jnp.sum(jnp.square(diff), axis=-1) / (4.0 * eta)

        log_ratio = (
            annealed(x, beta) - annealed(y, beta) + log_q(x, y, g_y) - log_q(y, x, g_x)
        )
        accept = jnp.minimum(jnp.exp(jnp.clip(log_ratio, -50.0, 50.0)), 1.0)
        u = jax.random.uniform(k_acc, accept.shape)
        x_new = jnp.where((u < accept)[:, None], y, x)
        return x_new, jnp.mean(accept)

    def rung(carry, inp):
        x, logw = carry
        beta_prev, beta, i = inp
        # weight update at the current state (Neal 2001, eq. 11)
        logw = logw + (beta - beta_prev) * (base.energy(x) - target.energy(x))

        # n_transitions MALA sweeps invariant for f_beta
        def sweep(j, state):
            x_, acc_ = state
            x_, a = mala_step(
                x_, jax.random.fold_in(jax.random.fold_in(k_run, i), j), beta, step_size
            )
            return x_, acc_ + a

        x, acc = jax.lax.fori_loop(0, n_transitions, sweep, (x, jnp.float32(0.0)))
        return (x, logw), acc / n_transitions

    n_rungs = betas.shape[0] - 1
    inputs = (betas[:-1], betas[1:], jnp.arange(n_rungs))
    (x_f, logw), accs = jax.lax.scan(rung, (x0, jnp.zeros(n_samples)), inputs)

    return _ais_statistics(base, x_f, logw, jnp.mean(accs), n_samples)


def _ais_statistics(base, samples, logw, acc_mean, n_samples) -> AISResult:
    log_n = math.log(n_samples)
    log_z_ratio = jax.scipy.special.logsumexp(logw) - log_n
    ess = jnp.exp(
        2.0 * jax.scipy.special.logsumexp(logw) - jax.scipy.special.logsumexp(2.0 * logw)
    )
    return AISResult(
        samples=samples,
        log_weights=logw,
        log_z=base.log_z() + log_z_ratio,
        log_z_ratio=log_z_ratio,
        ess=ess,
        acceptance_rate=acc_mean,
    )


def annealed_importance_sampling(
    key: Array,
    target: Energy,
    base: Optional[GaussianEnergy] = None,
    dim: Optional[int] = None,
    *,
    n_samples: int = 1024,
    n_rungs: int = 200,
    n_transitions: int = 1,
    step_size: float = 0.1,
    betas: Optional[Array] = None,
) -> AISResult:
    r"""Estimate :math:`\log Z` of ``target``'s density :math:`e^{-U}/Z`.

    ``base`` must expose exact ``sample`` and ``log_z`` (any
    :class:`GaussianEnergy`; default standard normal, which requires ``dim``).
    ``betas`` overrides the default linear schedule ``linspace(0, 1,
    n_rungs+1)``. Returns an :class:`AISResult`; ``result.ess`` near
    ``n_samples`` indicates a well-mixed anneal, near 1 a collapsed one
    (increase ``n_rungs`` or ``n_transitions``).
    """
    if base is None:
        if dim is None:
            raise ValueError("provide either base= or dim= for the default base")
        base = GaussianEnergy.standard(dim)
    if betas is None:
        betas = jnp.linspace(0.0, 1.0, n_rungs + 1)
    betas = jnp.asarray(betas, jnp.float32)
    if betas.ndim != 1 or betas.shape[0] < 2:
        raise ValueError("betas must be a 1D schedule with at least 2 entries")
    return _ais_impl(
        target, base, key, betas, float(step_size), int(n_samples), int(n_transitions)
    )
