r"""Concrete interpolants: linear (OT/rectified-flow), cosine (GVP), variance-preserving.

Reference: ``torchebm/interpolants/linear.py:10-78``, ``cosine.py:11-80``,
``variance_preserving.py:10-118``.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from .base import BaseInterpolant, expand_t_like_x

Array = jax.Array

__all__ = ["LinearInterpolant", "CosineInterpolant", "VariancePreservingInterpolant"]


@struct.dataclass
class LinearInterpolant(BaseInterpolant):
    r"""Linear / optimal-transport path: :math:`\alpha(t)=t`, :math:`\sigma(t)=1-t`."""

    def compute_alpha_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        return t, jnp.ones_like(t)

    def compute_sigma_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        return 1 - t, -jnp.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t: Array) -> Array:
        return 1.0 / jnp.maximum(jnp.asarray(t), 1e-8)


@struct.dataclass
class CosineInterpolant(BaseInterpolant):
    r"""Geodesic variance-preserving (GVP) path:
    :math:`\alpha(t)=\sin(\pi t/2)`, :math:`\sigma(t)=\cos(\pi t/2)`."""

    def compute_alpha_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        return jnp.sin(t * math.pi / 2), (math.pi / 2) * jnp.cos(t * math.pi / 2)

    def compute_sigma_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        return jnp.cos(t * math.pi / 2), -(math.pi / 2) * jnp.sin(t * math.pi / 2)

    def compute_d_alpha_alpha_ratio_t(self, t: Array) -> Array:
        t = jnp.asarray(t)
        return math.pi / (2 * jnp.maximum(jnp.tan(t * math.pi / 2), 1e-8))


@struct.dataclass
class VariancePreservingInterpolant(BaseInterpolant):
    r"""DDPM-style VP path with linear-:math:`\beta` schedule.

    .. math::
        \alpha(t) = \exp\!\big(-\tfrac14 (1-t)^2(\sigma_{max}-\sigma_{min})
        - \tfrac12 (1-t)\sigma_{min}\big), \qquad
        \sigma(t) = \sqrt{1-\alpha(t)^2}

    ``compute_drift`` uses the exact :math:`\beta(t)` parameterization
    (reference ``variance_preserving.py:102-118``).
    """

    sigma_min: float = struct.field(pytree_node=False, default=0.1)
    sigma_max: float = struct.field(pytree_node=False, default=20.0)

    def _log_mean_coeff(self, t: Array) -> Array:
        return (
            -0.25 * (1 - t) ** 2 * (self.sigma_max - self.sigma_min)
            - 0.5 * (1 - t) * self.sigma_min
        )

    def _d_log_mean_coeff(self, t: Array) -> Array:
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def compute_alpha_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        alpha = jnp.exp(self._log_mean_coeff(t))
        return alpha, alpha * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t: Array) -> Tuple[Array, Array]:
        t = jnp.asarray(t)
        exp_p = jnp.exp(2 * self._log_mean_coeff(t))
        sigma = jnp.sqrt(jnp.maximum(1 - exp_p, 1e-12))
        d_sigma = exp_p * (2 * self._d_log_mean_coeff(t)) / (-2 * sigma)
        return sigma, d_sigma

    def compute_d_alpha_alpha_ratio_t(self, t: Array) -> Array:
        return self._d_log_mean_coeff(jnp.asarray(t))

    def compute_drift(self, x: Array, t: Array) -> Tuple[Array, Array]:
        te = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1 - te) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2 * jnp.ones_like(x)
