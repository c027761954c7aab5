r"""Riemannian-manifold HMC (Girolami & Calderhead 2011).

Reference: ``torchebm/samplers/hmc.py:318-736``. Hamiltonian with a
position-dependent SPD metric :math:`G(x)`:

.. math::
    H(x, p) = U(x) + \tfrac12 p^\top G(x)^{-1} p + \tfrac12 \log|G(x)|

Trajectories use the non-separable :class:`GeneralisedLeapfrogIntegrator`
(Picard implicit stages). The force :math:`-\partial H/\partial x` is obtained
by autodiff through the potential *and* the metric kinetic terms — JAX
differentiates the batched Cholesky/triangular-solve pipeline directly, so the
reference's identity-keyed Cholesky memo cache (``hmc.py:472-490``) is
unnecessary: XLA common-subexpression-eliminates repeated factorizations at
the same ``x`` inside one compiled step. NaN/Inf proposals are rejected
outright (``hmc.py:697-702``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from ..integrators import BaseSymplecticIntegrator, resolve_integrator
from .base import BaseSampler

Array = jax.Array

__all__ = ["RiemannianManifoldHMC"]


def _chol(G: Array) -> Array:
    return jnp.linalg.cholesky(G)


def _solve_metric(L: Array, p: Array) -> Array:
    """G⁻¹ p from the Cholesky factor (two batched triangular solves)."""
    y = jax.scipy.linalg.solve_triangular(L, p[..., None], lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )[..., 0]


def _logdet_from_chol(L: Array) -> Array:
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


@struct.dataclass
class RiemannianManifoldHMC(BaseSampler):
    """RMHMC sampler over a user-supplied differentiable metric ``x -> G(x)``.

    ``metric_fn`` must return a symmetric positive-definite ``(batch, dim,
    dim)`` tensor and be differentiable w.r.t. ``x`` (it sits inside the
    autodiff force). With the identity metric this reduces exactly to HMC.
    """

    model: Energy
    metric_fn: Callable[[Array], Array] = struct.field(pytree_node=False, default=None)
    step_size: Union[float, BaseScheduler] = 1e-3
    n_leapfrog_steps: int = struct.field(pytree_node=False, default=10)
    integrator: BaseSymplecticIntegrator = None

    def __post_init__(self):
        if not callable(self.metric_fn):
            raise TypeError("metric_fn must be callable: x -> G(x)")
        if self.n_leapfrog_steps <= 0:
            raise ValueError("n_leapfrog_steps must be positive")
        integ = resolve_integrator(
            self.integrator, default="generalised_leapfrog", families=("symplectic",)
        )
        if integ.separable:
            raise TypeError(
                "RiemannianManifoldHMC requires a non-separable symplectic "
                f"integrator; got separable {type(integ).__name__}."
            )
        object.__setattr__(self, "integrator", integ)

    # -------------------------------------------------------------- physics

    def _hamiltonian(self, x: Array, p: Array, model_kwargs) -> Array:
        L = _chol(self.metric_fn(x))
        kinetic = 0.5 * jnp.sum(p * _solve_metric(L, p), axis=-1)
        return (
            self.energy_of(x, model_kwargs)
            + kinetic
            + 0.5 * _logdet_from_chol(L)
        )

    def _force(self, x: Array, p: Array, model_kwargs) -> Array:
        r""":math:`-\partial H/\partial x` with :math:`p` held fixed (autodiff)."""
        return -jax.grad(lambda xx: jnp.sum(self._hamiltonian(xx, p, model_kwargs)))(x)

    def _velocity(self, x: Array, p: Array) -> Array:
        r""":math:`\partial H/\partial p = G(x)^{-1} p`."""
        return _solve_metric(_chol(self.metric_fn(x)), p)

    def _momentum(self, key: Array, x: Array) -> Array:
        r""":math:`p = L z \sim N(0, G(x))` for :math:`G = L L^\top`."""
        z = jax.random.normal(key, x.shape, x.dtype)
        L = _chol(self.metric_fn(x))
        return jnp.einsum("...ij,...j->...i", L, z)

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, key, model_kwargs):
        return {"x": x0, "accept_rate": jnp.float32(0.0)}

    def step(self, carry, i, key, model_kwargs):
        x = carry["x"]
        k_mom, k_acc = jax.random.split(key)
        p = self._momentum(k_mom, x)
        cur_h = jnp.clip(self._hamiltonian(x, p, model_kwargs), -1e10, 1e10)

        proposed = self.integrator.integrate(
            {"x": x, "p": p},
            sched_value(self.step_size, i),
            self.n_leapfrog_steps,
            force=lambda x_, p_, t_: self._force(x_, p_, model_kwargs),
            velocity=lambda x_, p_, t_: self._velocity(x_, p_),
        )
        x_prop, p_prop = proposed["x"], proposed["p"]
        prop_h = self._hamiltonian(x_prop, p_prop, model_kwargs)

        finite = jnp.all(
            jnp.isfinite(x_prop.reshape(x_prop.shape[0], -1)), axis=-1
        ) & jnp.isfinite(prop_h)
        diff = jnp.clip(cur_h - jnp.clip(prop_h, -1e10, 1e10), -50.0, 50.0)
        accept_prob = jnp.where(finite, jnp.minimum(jnp.exp(diff), 1.0), 0.0)
        u = jax.random.uniform(k_acc, accept_prob.shape)
        accepted = u < accept_prob
        mask = accepted.reshape((-1,) + (1,) * (x.ndim - 1))
        return {
            "x": jnp.where(mask, x_prop, x),
            "accept_rate": jnp.mean(accept_prob),
        }

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}
