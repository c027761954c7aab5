r"""Hamiltonian Monte Carlo with optional dual-averaging step-size adaptation.

Reference: ``torchebm/samplers/hmc.py:19-315``. One transition: sample momentum
:math:`p \sim N(0, M)`, integrate ``n_leapfrog_steps`` of leapfrog under the
force :math:`-\nabla U`, then Metropolis-accept with probability
:math:`\min(1, e^{H_{\text{cur}} - H_{\text{prop}}})`. Numerical guards follow
the reference: energies clamped to ±1e10, Hamiltonian difference to ±50,
``safe=True`` leapfrog (force clamp + NaN scrub); everything is branch-free
``jnp.where`` so a chain never syncs to host.

**Build addition over the reference:** Nesterov dual-averaging
step-size adaptation (Hoffman & Gelman 2014, Algorithm 5) targeting a desired
acceptance rate, run over ``n_warmup`` adaptation transitions inside the same
compiled program — the adapted ``log ε`` lives in the scan carry.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_init, sched_value
from ..integrators import (
    BaseSymplecticIntegrator,
    resolve_integrator,
)
from .base import BaseSampler

Array = jax.Array

__all__ = ["HamiltonianMonteCarlo", "DualAveragingState"]


@struct.dataclass
class DualAveragingState:
    """Carry for Nesterov dual averaging of ``log step_size``."""

    log_eps: Array
    log_eps_bar: Array
    h_bar: Array
    t: Array  # adaptation step counter (float)

    @classmethod
    def init(cls, eps0: float) -> "DualAveragingState":
        log_eps = jnp.float32(math.log(eps0))
        return cls(
            log_eps=log_eps,
            log_eps_bar=jnp.float32(0.0),
            h_bar=jnp.float32(0.0),
            t=jnp.float32(0.0),
        )


def dual_averaging_update(
    state: DualAveragingState,
    accept_prob: Array,
    target_accept: float,
    mu: Array,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One dual-averaging update (Hoffman & Gelman 2014, eqs. in Algorithm 5)."""
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target_accept - accept_prob)
    log_eps = mu - jnp.sqrt(t) / gamma * h_bar
    eta_x = jnp.power(t, -kappa)
    log_eps_bar = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_bar
    return DualAveragingState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t)


@struct.dataclass
class HamiltonianMonteCarlo(BaseSampler):
    """HMC sampler (leapfrog trajectories + Metropolis test).

    Args mirror the reference ctor (``hmc.py:53-91``): ``mass`` may be a
    scalar or a per-dimension diagonal array. ``dual_averaging=True`` enables
    warmup step-size adaptation via :meth:`sample` 's ``n_warmup``.
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    n_leapfrog_steps: int = struct.field(pytree_node=False, default=10)
    mass: Optional[Union[float, Array]] = None
    integrator: BaseSymplecticIntegrator = None
    dual_averaging: bool = struct.field(pytree_node=False, default=False)
    target_accept: float = struct.field(pytree_node=False, default=0.8)

    def __post_init__(self):
        if self.n_leapfrog_steps <= 0:
            raise ValueError("n_leapfrog_steps must be positive")
        integ = resolve_integrator(
            self.integrator, default="leapfrog", families=("symplectic",)
        )
        if not integ.separable:
            raise TypeError(
                "HamiltonianMonteCarlo requires a separable symplectic "
                f"integrator; got non-separable {type(integ).__name__}. "
                "Use RiemannianManifoldHMC for non-separable Hamiltonians."
            )
        object.__setattr__(self, "integrator", integ)

    # ------------------------------------------------------------------

    def _momentum(self, key: Array, x: Array) -> Array:
        p = jax.random.normal(key, x.shape, x.dtype)
        if self.mass is None:
            return p
        mass = jnp.asarray(self.mass, x.dtype)
        if mass.ndim == 0:
            return p * jnp.sqrt(mass)
        return p * jnp.sqrt(mass).reshape((1,) * (x.ndim - 1) + (-1,))

    def _kinetic(self, p: Array) -> Array:
        sq = jnp.square(p)
        if self.mass is None:
            return 0.5 * jnp.sum(sq.reshape(sq.shape[0], -1), axis=-1)
        mass = jnp.asarray(self.mass, p.dtype)
        if mass.ndim == 0:
            return 0.5 * jnp.sum(sq.reshape(sq.shape[0], -1), axis=-1) / mass
        sq = sq / mass.reshape((1,) * (p.ndim - 1) + (-1,))
        return 0.5 * jnp.sum(sq.reshape(sq.shape[0], -1), axis=-1)

    def _transition(self, x: Array, key: Array, eps, model_kwargs) -> Tuple[Array, Array]:
        """One MH proposal; returns (new_x, mean acceptance probability)."""
        k_mom, k_acc = jax.random.split(key)
        p = self._momentum(k_mom, x)
        cur_e = jnp.clip(self.energy_of(x, model_kwargs), -1e10, 1e10)
        cur_h = cur_e + jnp.clip(self._kinetic(p), 0.0, 1e10)

        proposed = self.integrator.integrate(
            {"x": x, "p": p},
            eps,
            self.n_leapfrog_steps,
            self.mass,
            drift=lambda x_, t_: -self.gradient_of(x_, model_kwargs),
            safe=True,
        )
        prop_e = jnp.clip(self.energy_of(proposed["x"], model_kwargs), -1e10, 1e10)
        prop_h = prop_e + jnp.clip(self._kinetic(proposed["p"]), 0.0, 1e10)

        diff = jnp.clip(cur_h - prop_h, -50.0, 50.0)
        accept_prob = jnp.minimum(jnp.exp(diff), 1.0)
        u = jax.random.uniform(k_acc, accept_prob.shape)
        accepted = u < accept_prob
        mask = accepted.reshape((-1,) + (1,) * (x.ndim - 1))
        x_new = jnp.where(mask, proposed["x"], x)
        return x_new, jnp.mean(accept_prob)

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, key, model_kwargs):
        return {"x": x0, "accept_rate": jnp.float32(0.0)}

    def step(self, carry, i, key, model_kwargs):
        eps = sched_value(self.step_size, i)
        x_new, acc = self._transition(carry["x"], key, eps, model_kwargs)
        out = dict(carry)
        out["x"] = x_new
        out["accept_rate"] = acc
        return out

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}

    # ---------------------------------------------------------------- warmup

    def warmup(
        self,
        key: Array,
        x: Optional[Array] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_warmup: int = 500,
        n_samples: int = 1,
        *,
        adapt_mass: bool = False,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Dual-averaging warmup: returns ``(warmed x, adapted step_size)``.

        Runs ``n_warmup`` adaptation transitions in one compiled scan; the
        returned step size is ``exp(log_eps_bar)`` (the averaged iterate), the
        standard freeze value. Typical use::

            x, eps = hmc.warmup(key, dim=2, n_warmup=500, n_samples=64)
            samples = hmc.replace(step_size=eps).sample(key2, x=x, n_steps=1000)

        ``adapt_mass=True`` additionally estimates a **diagonal mass matrix**
        Stan-style — the per-dimension posterior variance is pooled over all
        chains and the second half of warmup (skipping the transient), and
        the metric is its inverse, ``mass = 1/var(x)`` — and returns the
        triple ``(warmed x, adapted step_size, mass)``::

            x, eps, mass = hmc.warmup(key, dim=2, n_warmup=500, n_samples=64,
                                      adapt_mass=True)
            tuned = hmc.replace(step_size=eps, mass=mass)
        """
        model_kwargs = model_kwargs or {}
        key_init, key_run = jax.random.split(key)
        x0 = self._init_state(key_init, x, dim, n_samples)
        eps0 = sched_init(self.step_size)
        mu = jnp.float32(math.log(10.0 * eps0))
        x_f, da_f, var = _warmup_impl(
            self, x0, key_run, n_warmup, self.target_accept, mu,
            DualAveragingState.init(eps0), model_kwargs,
        )
        eps = float(jnp.exp(da_f.log_eps_bar))
        if adapt_mass:
            return x_f, eps, 1.0 / jnp.clip(var, 1e-8, 1e8)
        return x_f, eps


from functools import partial  # noqa: E402


@partial(jax.jit, static_argnames=("n_warmup", "target_accept"))
def _warmup_impl(sampler, x0, key, n_warmup, target_accept, mu, da0, model_kwargs):
    collect_from = n_warmup // 2  # skip the transient for the variance window

    def body(carry, i):
        x, da, s1, s2, n = carry
        x_new, acc = sampler._transition(
            x, jax.random.fold_in(key, i), jnp.exp(da.log_eps), model_kwargs
        )
        da = dual_averaging_update(da, acc, target_accept, mu)
        flat = x_new.reshape(x_new.shape[0], -1)
        take = (i >= collect_from).astype(x0.dtype)
        s1 = s1 + take * jnp.sum(flat, axis=0)
        s2 = s2 + take * jnp.sum(flat * flat, axis=0)
        n = n + take * flat.shape[0]
        return (x_new, da, s1, s2, n), None

    flat_d = x0.reshape(x0.shape[0], -1).shape[-1]
    carry0 = (x0, da0, jnp.zeros(flat_d, x0.dtype), jnp.zeros(flat_d, x0.dtype),
              jnp.float32(0.0))
    (x_f, da_f, s1, s2, n), _ = jax.lax.scan(body, carry0, jnp.arange(n_warmup))
    n = jnp.maximum(n, 2.0)
    var = s2 / n - jnp.square(s1 / n)
    return x_f, da_f, var.reshape(x0.shape[1:])
