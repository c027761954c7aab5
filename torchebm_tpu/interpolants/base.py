r"""Stochastic interpolant contract.

Reference: ``torchebm/core/base_interpolant.py:82-244``. An interpolant defines
the conditional path

.. math:: x_t = \alpha(t)\,x_1 + \sigma(t)\,x_0

between noise :math:`x_0` and data :math:`x_1`. Interpolants are stateless
zero-leaf pytrees; every method is pure ``jnp`` over (possibly traced) ``t``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from ..core import struct

Array = jax.Array

__all__ = ["BaseInterpolant", "expand_t_like_x", "DIFFUSION_FORMS"]

DIFFUSION_FORMS = (
    "constant",
    "SBDM",
    "sigma",
    "linear",
    "decreasing",
    "increasing-decreasing",
)


def expand_t_like_x(t: Array, x: Array) -> Array:
    """Expand ``(B,)`` times to ``(B, 1, ..., 1)`` for broadcasting against ``x``.

    Scalar ``t`` passes through unchanged (broadcasts trivially). Reference
    ``base_interpolant.py:9-20``.
    """
    t = jnp.asarray(t)
    if t.ndim == 0:
        return t
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


class BaseInterpolant:
    r"""Abstract interpolant: subclasses provide ``compute_alpha_t`` / ``compute_sigma_t``
    returning ``(value, time-derivative)`` pairs."""

    def compute_alpha_t(self, t: Array) -> Tuple[Array, Array]:
        raise NotImplementedError

    def compute_sigma_t(self, t: Array) -> Tuple[Array, Array]:
        raise NotImplementedError

    def compute_d_alpha_alpha_ratio_t(self, t: Array) -> Array:
        r""":math:`\dot\alpha(t)/\alpha(t)`; override for better stability."""
        alpha, d_alpha = self.compute_alpha_t(t)
        return d_alpha / jnp.maximum(alpha, 1e-8)

    def interpolate(self, x0: Array, x1: Array, t: Array) -> Tuple[Array, Array]:
        r"""``(x_t, u_t)`` with :math:`x_t = \alpha x_1 + \sigma x_0`,
        :math:`u_t = \dot\alpha x_1 + \dot\sigma x_0`."""
        te = expand_t_like_x(t, x0)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        return alpha * x1 + sigma * x0, d_alpha * x1 + d_sigma * x0

    def compute_drift(self, x: Array, t: Array) -> Tuple[Array, Array]:
        r"""Score-parameterized probability-flow drift pieces.

        Returns ``(drift_mean, drift_var)`` such that the PF-ODE reads
        ``dx = [drift_mean + drift_var · score] dt`` (note: ``drift_mean``
        is returned already negated, matching the reference,
        ``base_interpolant.py:107-130``).
        """
        te = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        drift_mean = alpha_ratio * x
        drift_var = alpha_ratio * sigma**2 - sigma * d_sigma
        return -drift_mean, drift_var

    def compute_diffusion(self, x: Array, t: Array, form: str = "SBDM", norm: float = 1.0) -> Array:
        """Diffusion coefficient for SDE sampling (6 forms, ``base_interpolant.py:132-175``)."""
        te = expand_t_like_x(t, x)
        sigma, _ = self.compute_sigma_t(te)
        _, drift_var = self.compute_drift(x, t)
        if form == "constant":
            return norm * jnp.ones_like(drift_var)
        if form == "SBDM":
            return norm * drift_var / (sigma + 1e-8)
        if form == "sigma":
            return norm * sigma
        if form == "linear":
            return norm * (1 - te) * jnp.ones_like(drift_var)
        if form == "decreasing":
            return norm * (1 - te) ** 2 * jnp.ones_like(drift_var)
        if form == "increasing-decreasing":
            return norm * 4 * te * (1 - te) * jnp.ones_like(drift_var)
        raise ValueError(
            f"Unknown diffusion form '{form}'. Choose from: {', '.join(DIFFUSION_FORMS)}"
        )

    # ---------------------------------------------------------- conversions

    def velocity_to_score(self, velocity: Array, x: Array, t: Array) -> Array:
        """Velocity → score conversion (``base_interpolant.py:177-203``)."""
        te = expand_t_like_x(t, x)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        alpha = jnp.maximum(alpha, 1e-8)
        reverse_alpha_ratio = alpha / d_alpha
        var = sigma**2 - reverse_alpha_ratio * d_sigma * sigma
        return (reverse_alpha_ratio * velocity - x) / jnp.maximum(var, 1e-12)

    def velocity_to_noise(self, velocity: Array, x: Array, t: Array) -> Array:
        """Velocity → noise conversion with sign-preserving denominator clamps."""
        te = expand_t_like_x(t, x)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        d_alpha = jnp.where(jnp.abs(d_alpha) < 1e-8, 1e-8, d_alpha)
        reverse_alpha_ratio = alpha / d_alpha
        var = sigma - reverse_alpha_ratio * d_sigma
        var = jnp.where(
            jnp.abs(var) < 1e-12,
            jnp.where(var == 0, 1e-12, jnp.sign(var) * 1e-12),
            var,
        )
        return (x - reverse_alpha_ratio * velocity) / var

    def score_to_velocity(self, score: Array, x: Array, t: Array) -> Array:
        drift_mean, drift_var = self.compute_drift(x, t)
        return drift_var * score - drift_mean
