r"""Metropolis-adjusted Langevin algorithm (MALA).

Build addition beyond the reference (TorchEBM ships unadjusted Langevin only,
``torchebm/samplers/langevin_dynamics.py``): the same overdamped-Langevin
proposal with a Metropolis–Hastings correction, making the chain exactly
invariant for :math:`e^{-U}` at any step size.

One transition from :math:`x`:

.. math::
    y &= x - \eta\,\nabla U(x) + \sqrt{2\eta}\,\varepsilon \\
    \log q(b\mid a) &= -\lVert b - a + \eta \nabla U(a)\rVert^2 / (4\eta) \\
    \alpha &= \min\!\big(1,\ e^{\,U(x)-U(y)+\log q(x\mid y)-\log q(y\mid x)}\big)

Numerical guards follow the HMC sampler (``samplers/hmc.py``): energies
clamped to ±1e10 and the log-ratio to ±50; acceptance is branch-free
``jnp.where`` so the compiled chain never syncs to host.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from .base import BaseSampler

Array = jax.Array

__all__ = ["MetropolisAdjustedLangevin"]


@struct.dataclass
class MetropolisAdjustedLangevin(BaseSampler):
    """MALA sampler: Langevin proposal + exact Metropolis–Hastings correction.

    ``step_size`` is schedulable. Diagnostics add ``acceptance_rate`` to the
    standard ``mean``/``var``/``energy`` keys. A practical tuning target is an
    acceptance rate near 0.574 (Roberts & Rosenthal optimal scaling).
    """

    model: Energy = None
    step_size: Union[float, BaseScheduler] = 1e-2

    def _log_q(self, b: Array, a: Array, grad_a: Array, eta) -> Array:
        diff = b - a + eta * grad_a
        sq = jnp.sum(jnp.square(diff).reshape(diff.shape[0], -1), axis=-1)
        return -sq / (4.0 * eta)

    def _transition(
        self, x: Array, key: Array, eta, model_kwargs
    ) -> Tuple[Array, Array]:
        k_prop, k_acc = jax.random.split(key)
        grad_x = self.gradient_of(x, model_kwargs)
        eps = jax.random.normal(k_prop, x.shape, x.dtype)
        y = x - eta * grad_x + jnp.sqrt(2.0 * eta) * eps

        grad_y = self.gradient_of(y, model_kwargs)
        u_x = jnp.clip(self.energy_of(x, model_kwargs), -1e10, 1e10)
        u_y = jnp.clip(self.energy_of(y, model_kwargs), -1e10, 1e10)
        log_ratio = (
            u_x - u_y + self._log_q(x, y, grad_y, eta) - self._log_q(y, x, grad_x, eta)
        )
        accept_prob = jnp.minimum(jnp.exp(jnp.clip(log_ratio, -50.0, 50.0)), 1.0)
        u = jax.random.uniform(k_acc, accept_prob.shape)
        mask = (u < accept_prob).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(mask, y, x), jnp.mean(accept_prob)

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, key, model_kwargs) -> Dict[str, Any]:
        return {"x": x0, "accept_rate": jnp.float32(0.0)}

    def step(self, carry, i, key, model_kwargs):
        eta = sched_value(self.step_size, i)
        x_new, acc = self._transition(carry["x"], key, eta, model_kwargs)
        out = dict(carry)
        out["x"] = x_new
        out["accept_rate"] = acc
        return out

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}
