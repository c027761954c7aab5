r"""Energy function contracts and analytic test energies.

JAX re-design of the reference's ``BaseModel`` family
(``torchebm/core/base_model.py:49-316``). Key differences from the torch design:

- Energies are **immutable pytrees** (``flax.struct.dataclass``), so they flow
  through ``jit``/``scan``/``grad``/``vmap`` and across device meshes without a
  module system. Parameters (means, covariances, ...) are pytree leaves, so a
  jitted sampler does not recompile when they change.
- ``gradient`` defaults to ``jax.grad`` instead of ``torch.autograd`` — it is
  differentiable-through by construction (the reference needs
  ``create_graph=True`` plumbing; composed ``jax.grad`` just works).
- No device/dtype bookkeeping: placement is the caller's concern via
  ``jax.device_put``/shardings; dtype follows the inputs.

The contract (reference ``base_model.py:49-60``): ``energy(x)`` maps
``(batch, *event_dims) -> (batch,)`` scalar energies = unnormalized negative
log-density. ``gradient(x)`` is :math:`\nabla_x E(x)` with the same shape as
``x``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from . import struct

Array = jax.Array

__all__ = [
    "Energy",
    "WrappedEnergy",
    "as_energy",
    "DoubleWellEnergy",
    "GaussianEnergy",
    "GaussianMixtureEnergy",
    "HarmonicEnergy",
    "RosenbrockEnergy",
    "AckleyEnergy",
    "RastriginEnergy",
]


def _atleast_batch(x: Array) -> Array:
    """Promote an unbatched event ``(d,)`` to a singleton batch ``(1, d)``.

    Mirrors the reference's ``if x.ndim == 1: x = x.unsqueeze(0)`` convention
    (``base_model.py:146-148``). ndim is static under ``jit``.
    """
    return x[None] if x.ndim == 1 else x


class Energy:
    """Energy function base contract.

    Subclasses implement :meth:`energy`. Everything else (``__call__``,
    autodiff :meth:`gradient`, :meth:`score`, :meth:`unnorm_log_prob`) derives
    from it. Conditioning flows as keyword arguments straight through to
    ``energy`` (the reference's ``model_kwargs`` convention,
    ``base_model.py:62-85``); unknown kwargs raise at trace time.
    """

    def energy(self, x: Array, **kwargs: Any) -> Array:
        raise NotImplementedError

    def __call__(self, x: Array, **kwargs: Any) -> Array:
        return self.energy(x, **kwargs)

    def gradient(self, x: Array, **kwargs: Any) -> Array:
        r""":math:`\nabla_x E(x)`, same shape as ``x``.

        Default is exact reverse-mode autodiff. Batch rows are independent, so
        differentiating ``sum(E)`` gives the per-sample gradient in one pass
        (reference uses ``grad_outputs=ones`` identically,
        ``base_model.py:113-119``).
        """
        return jax.grad(lambda xx: jnp.sum(self.energy(xx, **kwargs)))(x)

    def score(self, x: Array, **kwargs: Any) -> Array:
        r"""Stein score :math:`\nabla_x \log p(x) = -\nabla_x E(x)`."""
        return -self.gradient(x, **kwargs)

    def unnorm_log_prob(self, x: Array, **kwargs: Any) -> Array:
        """Unnormalized log-density ``-E(x)``."""
        return -self.energy(x, **kwargs)

    def value_and_grad(self, x: Array, **kwargs: Any) -> tuple[Array, Array]:
        """``(E(x), ∇E(x))`` in one fused pass (one forward + one backward)."""
        e, pullback = jax.vjp(lambda xx: self.energy(xx, **kwargs), x)
        (g,) = pullback(jnp.ones_like(e))
        return e, g


@struct.dataclass
class WrappedEnergy(Energy):
    """Adapts a plain callable ``fn(params, x, **kw) -> (B,)`` into an :class:`Energy`.

    ``fn`` is static (hashable, baked into the jit cache key); ``params`` is a
    pytree leaf container, so training updates do not retrigger compilation.
    This is how model ``apply`` functions (the library's networks, or any
    flax/haiku-style module) enter the sampler/loss stack:
    ``WrappedEnergy(model.apply, params)``.
    """

    fn: Callable[..., Array] = struct.field(pytree_node=False)
    params: Any = None

    def energy(self, x: Array, **kwargs: Any) -> Array:
        if self.params is None:
            out = self.fn(x, **kwargs)
        else:
            out = self.fn(self.params, x, **kwargs)
        return jnp.reshape(out, (x.shape[0],) if x.ndim > 1 else out.shape)


def as_energy(model: Any, params: Any = None) -> Energy:
    """Coerce ``model`` into an :class:`Energy`.

    Accepts an :class:`Energy` (returned as-is), a module-like object with
    ``.apply`` (requires ``params``), or a bare callable
    ``fn(x)->(B,)`` / ``fn(params,x)->(B,)``.
    """
    if isinstance(model, Energy):
        return model
    if hasattr(model, "apply") and not callable(model):  # pragma: no cover
        raise TypeError(f"Cannot interpret {model!r} as an energy function.")
    if hasattr(model, "apply") and params is not None:
        return WrappedEnergy(fn=model.apply, params=params)
    if callable(model):
        return WrappedEnergy(fn=model, params=params)
    raise TypeError(f"Cannot interpret {model!r} as an energy function.")


# ---------------------------------------------------------------------------
# Analytic energies (reference base_model.py:130-316). These double as ground
# truth for the statistical sampler tests and as benchmark workloads.
# ---------------------------------------------------------------------------


@struct.dataclass
class DoubleWellEnergy(Energy):
    r"""Double-well potential :math:`E(x) = h \sum_i (x_i^2 - b^2)^2`.

    Reference: ``base_model.py:130-148``. Wells at :math:`\pm b` per dimension.
    """

    barrier_height: float = 2.0
    b: float = 1.0

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        return self.barrier_height * jnp.sum((x * x - self.b**2) ** 2, axis=-1)

    def gradient(self, x: Array) -> Array:
        # Analytic: 4 h x (x² - b²); elementwise-separable — this is the form
        # the whole-chain Langevin kernel inlines (ops/fused_langevin.py).
        return 4.0 * self.barrier_height * x * (x * x - self.b**2)


@struct.dataclass
class GaussianEnergy(Energy):
    r"""Gaussian energy :math:`E(x) = \tfrac12 (x-\mu)^\top \Sigma^{-1} (x-\mu)`.

    Reference: ``base_model.py:151-210`` (stores ``cov_inv`` as a buffer; here
    both ``cov`` and its inverse are pytree leaves computed eagerly at
    construction via :meth:`create`, so no per-step solve appears inside
    scanned sampler loops).
    """

    mean: Array
    cov: Array
    cov_inv: Array

    @classmethod
    def create(cls, mean, cov) -> "GaussianEnergy":
        mean = jnp.asarray(mean, dtype=jnp.result_type(float))
        cov = jnp.asarray(cov, dtype=mean.dtype)
        if mean.ndim != 1:
            raise ValueError("Mean must be a 1D array.")
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError("Covariance must be a 2D square matrix.")
        if mean.shape[0] != cov.shape[0]:
            raise ValueError("Mean dimension must match covariance dimension.")
        return cls(mean=mean, cov=cov, cov_inv=jnp.linalg.inv(cov))

    # Convenience: GaussianEnergy.create is the public constructor, but tests
    # and examples often want a standard normal quickly.
    @classmethod
    def standard(cls, dim: int) -> "GaussianEnergy":
        return cls.create(jnp.zeros((dim,)), jnp.eye(dim))

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        delta = x - self.mean
        return 0.5 * jnp.einsum("bi,ij,bj->b", delta, self.cov_inv, delta)

    def gradient(self, x: Array) -> Array:
        delta = x - self.mean
        return delta @ self.cov_inv.T  # symmetric, .T for clarity

    def sample(self, key: Array, n: int) -> Array:
        """Exact i.i.d. draws via Cholesky — ground truth for sampler tests
        and the tractable base distribution for AIS log-Z estimation."""
        chol = jnp.linalg.cholesky(self.cov)
        eps = jax.random.normal(key, (n, self.mean.shape[0]), self.mean.dtype)
        return self.mean + eps @ chol.T

    def log_z(self) -> Array:
        r"""Exact log partition function :math:`\tfrac d2\log 2\pi +
        \tfrac12\log|\Sigma|` of :math:`e^{-E}`."""
        d = self.mean.shape[0]
        sign, logdet = jnp.linalg.slogdet(self.cov)
        return 0.5 * d * math.log(2 * math.pi) + 0.5 * logdet


@struct.dataclass
class GaussianMixtureEnergy(Energy):
    r"""Isotropic Gaussian-mixture energy :math:`E(x) = -\log \sum_k w_k N(x; \mu_k, \sigma^2 I)`.

    Build addition (not in the reference's analytic set): the exact energy of
    the 8gaussians / grid / pinwheel-style synthetic datasets, used as the
    headline Langevin benchmark target. ``log_weights``
    keeps the mixture computation in stable log-space
    (``logsumexp``); the analytic gradient is the responsibility-weighted sum,
    obtained here by autodiff of the fused logsumexp (XLA fuses it into the
    sampler loop).
    """

    means: Array  # (K, d)
    scale: Array  # scalar sigma
    log_weights: Array  # (K,)

    @classmethod
    def create(cls, means, scale=1.0, weights=None) -> "GaussianMixtureEnergy":
        means = jnp.asarray(means, dtype=jnp.result_type(float))
        if means.ndim != 2:
            raise ValueError("means must have shape (n_components, dim)")
        k = means.shape[0]
        if weights is None:
            log_w = jnp.full((k,), -math.log(k), dtype=means.dtype)
        else:
            w = jnp.asarray(weights, dtype=means.dtype)
            log_w = jnp.log(w / jnp.sum(w))
        return cls(means=means, scale=jnp.asarray(scale, means.dtype), log_weights=log_w)

    @classmethod
    def eight_gaussians(cls, radius: float = 4.0, scale: float = 0.4) -> "GaussianMixtureEnergy":
        """The classic ring of 8 modes (matches datasets.EightGaussiansDataset)."""
        ang = jnp.arange(8) * (2 * math.pi / 8)
        means = radius * jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
        return cls.create(means, scale=scale)

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        d = x.shape[-1]
        diff = x[:, None, :] - self.means[None, :, :]  # (B, K, d)
        sq = jnp.sum(diff * diff, axis=-1)  # (B, K)
        log_norm = d * jnp.log(self.scale) + 0.5 * d * math.log(2 * math.pi)
        comp_logp = self.log_weights - 0.5 * sq / (self.scale**2) - log_norm
        return -jax.scipy.special.logsumexp(comp_logp, axis=-1)

    def gradient(self, x: Array) -> Array:
        r"""Analytic :math:`\nabla E = (x - \sum_k r_k(x)\,\mu_k)/\sigma^2` with
        softmax responsibilities :math:`r_k` — one forward pass instead of the
        logsumexp VJP."""
        x = _atleast_batch(x)
        diff = x[:, None, :] - self.means[None, :, :]  # (B, K, d)
        logits = self.log_weights - 0.5 * jnp.sum(diff * diff, axis=-1) / (self.scale**2)
        resp = jax.nn.softmax(logits, axis=-1)  # (B, K)
        return (x - resp @ self.means) / (self.scale**2)

    def sample(self, key: Array, n: int) -> Array:
        """Exact i.i.d. draws — ground truth for sampler statistics tests."""
        kc, kn = jax.random.split(key)
        comp = jax.random.categorical(kc, self.log_weights, shape=(n,))
        eps = jax.random.normal(kn, (n, self.means.shape[-1]), self.means.dtype)
        return self.means[comp] + self.scale * eps


@struct.dataclass
class HarmonicEnergy(Energy):
    r"""Harmonic oscillator :math:`E(x) = \tfrac12 k \sum_i x_i^2` (``base_model.py:213-229``)."""

    k: float = 1.0

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        return 0.5 * self.k * jnp.sum(x * x, axis=-1)

    def gradient(self, x: Array) -> Array:
        return self.k * x


@struct.dataclass
class RosenbrockEnergy(Energy):
    r"""Rosenbrock valley :math:`\sum_i b(x_{i+1}-x_i^2)^2 + (a-x_i)^2` (``base_model.py:232-264``)."""

    a: float = 1.0
    b: float = 100.0

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        if x.shape[-1] < 2:
            raise ValueError("Rosenbrock energy requires at least 2 dimensions.")
        x_i, x_ip1 = x[..., :-1], x[..., 1:]
        return jnp.sum((self.a - x_i) ** 2 + self.b * (x_ip1 - x_i**2) ** 2, axis=-1)


@struct.dataclass
class AckleyEnergy(Energy):
    r"""Ackley function (``base_model.py:267-294``). Global minimum 0 at the origin."""

    a: float = 20.0
    b: float = 0.2
    c: float = 2 * math.pi

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        n = x.shape[-1]
        sum1 = jnp.sum(x * x, axis=-1)
        sum2 = jnp.sum(jnp.cos(self.c * x), axis=-1)
        term1 = -self.a * jnp.exp(-self.b * jnp.sqrt(sum1 / n))
        term2 = -jnp.exp(sum2 / n)
        return term1 + term2 + self.a + math.e


@struct.dataclass
class RastriginEnergy(Energy):
    r"""Rastrigin function :math:`a n + \sum_i x_i^2 - a\cos(2\pi x_i)` (``base_model.py:297-316``)."""

    a: float = 10.0

    def energy(self, x: Array) -> Array:
        x = _atleast_batch(x)
        n = x.shape[-1]
        return self.a * n + jnp.sum(x * x - self.a * jnp.cos(2 * math.pi * x), axis=-1)
