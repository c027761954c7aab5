r"""Score-matching objectives: exact/approx Hyvärinen, denoising, sliced.

Reference: ``torchebm/losses/score_matching.py:16-597`` and the score plumbing
in ``torchebm/core/base_loss.py:640-775``. JAX translation notes:

- ``compute_score`` is :math:`\nabla_x E` via ``jax.grad`` — the reference's
  ``create_graph=True`` double backward is just composed differentiation here.
- Exact SM's per-sample score + Laplacian is ``jax.vmap`` over
  ``jax.grad``/``jax.jacrev`` (the reference uses the same torch.func
  combinators, ``score_matching.py:180-193``); the reference's DTensor
  restriction does not exist — sharded params differentiate transparently, so
  the whole FSDP2 functional path (``base_loss.py:439-622``) has no analogue.
- Sliced SM computes score and Hessian-vector term together with one
  ``jax.jvp``-of-``jax.grad`` (forward-over-reverse) pass — equivalent to but
  cheaper than the reference's two ``create_graph`` autograd passes
  (``score_matching.py:540-559``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from .base import BaseLoss
from .loss_utils import mean_flat

Array = jax.Array

__all__ = ["BaseScoreMatching", "ScoreMatching", "DenoisingScoreMatching", "SlicedScoreMatching"]


class BaseScoreMatching(BaseLoss):
    """Shared machinery: model-score, data perturbation, regularization."""

    def compute_score(self, model, x: Array, model_kwargs) -> Array:
        r""":math:`\nabla_x E(x)` (reference sign convention,
        ``base_loss.py:640-681``)."""
        return jax.grad(lambda xx: jnp.sum(model.energy(xx, **(model_kwargs or {}))))(x)

    def perturb_data(self, x: Array, key: Array, noise_scale: float):
        noise = noise_scale * jax.random.normal(key, x.shape, x.dtype)
        return x + noise, noise

    def add_regularization(self, loss: Array, model, x: Array, model_kwargs) -> Array:
        """Default regularizer: mean ‖score‖² (reference ``base_loss.py:738-775``)."""
        if self.custom_regularization is not None:
            return self.custom_regularization(loss, model, x)
        if self.regularization_strength <= 0:
            return loss
        score = self.compute_score(model, x, model_kwargs)
        return loss + self.regularization_strength * jnp.mean(
            jnp.sum(jnp.square(score).reshape(x.shape[0], -1), axis=-1)
        )


@struct.dataclass
class ScoreMatching(BaseScoreMatching):
    r"""Hyvärinen (2005) score matching.

    ``hessian_method="exact"``: per-sample score + Laplacian via
    ``vmap(grad)``/``vmap(jacrev)`` — unconditional only (per-sample
    conditioning cannot batch through the vmap trace, same restriction as the
    reference, ``score_matching.py:163-175``).
    ``"approx"``: finite-difference Hutchinson-style probe (ε = 1e-5).
    """

    model: Energy = None
    hessian_method: str = struct.field(pytree_node=False, default="exact")
    regularization_strength: float = struct.field(pytree_node=False, default=0.0)
    custom_regularization: Optional[Callable] = struct.field(pytree_node=False, default=None)

    def __post_init__(self):
        if self.hessian_method not in ("exact", "approx"):
            raise ValueError(
                f"hessian_method must be 'exact' or 'approx', got {self.hessian_method!r}"
            )

    def __call__(self, params, x, key, *, model_kwargs=None):
        model = self._model(params)
        if self.hessian_method == "approx":
            loss = self._approx(model, x, key, model_kwargs)
        else:
            loss = self._exact(model, x, model_kwargs)
        return self.add_regularization(loss, model, x, model_kwargs)

    def _exact(self, model, x, model_kwargs):
        if model_kwargs:
            raise NotImplementedError(
                "Conditional exact score matching is not supported (per-sample "
                "conditioning cannot batch through the vmap Hessian trace). "
                "Use hessian_method='approx' or DenoisingScoreMatching."
            )
        batch = x.shape[0]
        x_flat = x.reshape(batch, -1)

        def score_fn(x_single):  # score of log p = -∇E
            return jax.grad(lambda xi: -model.energy(xi[None])[0])(x_single)

        def laplacian_fn(x_single):
            return jnp.trace(jax.jacrev(score_fn)(x_single))

        score = jax.vmap(score_fn)(x_flat)
        laplacian = jax.vmap(laplacian_fn)(x_flat)
        return jnp.mean(0.5 * jnp.sum(jnp.square(score), axis=-1) + laplacian)

    def _approx(self, model, x, key, model_kwargs):
        batch = x.shape[0]
        data_dim = math.prod(x.shape[1:])
        score = self.compute_score(model, x, model_kwargs)
        sq_term = 0.5 * jnp.mean(
            jnp.sum(jnp.square(score).reshape(batch, -1), axis=-1)
        )
        epsilon = 1e-5
        x_noise = x + epsilon * jax.random.normal(key, x.shape, x.dtype)
        score_noise = self.compute_score(model, x_noise, model_kwargs)
        hessian_trace = jnp.mean(
            jnp.sum(((score_noise - score) * (x_noise - x)).reshape(batch, -1), axis=-1)
        ) / (epsilon**2 * data_dim)
        return sq_term - hessian_trace


@struct.dataclass
class DenoisingScoreMatching(BaseScoreMatching):
    r"""Vincent (2011) DSM: perturb with σ-noise, regress the model score
    :math:`-\nabla E` onto :math:`-\text{noise}/\sigma^2` (reference
    ``score_matching.py:242-370``; see ``__call__`` for the deliberate sign
    fix vs the reference). Conditional-capable. The trained energy is
    directly sampleable with the library's Langevin/HMC samplers."""

    model: Energy = None
    noise_scale: float = struct.field(pytree_node=False, default=0.01)
    regularization_strength: float = struct.field(pytree_node=False, default=0.0)
    custom_regularization: Optional[Callable] = struct.field(pytree_node=False, default=None)

    def __call__(self, params, x, key, *, model_kwargs=None):
        model = self._model(params)
        x_perturbed, noise = self.perturb_data(x, key, self.noise_scale)
        # Regress the model score  s = -∇E  onto  ∇ log q(x̃|x) = -noise/σ²,
        # i.e. ∇E(x̃) → +noise/σ²: the trained E is LOW at data, so the same
        # Langevin/HMC samplers used for CD models draw from it directly, and
        # the convention matches ScoreMatching/SlicedScoreMatching (score =
        # -∇E). DELIBERATE sign deviation from the reference
        # (``score_matching.py:361``, which regresses +∇E onto -noise/σ² —
        # producing an inverted energy its own Langevin sampler then descends
        # AWAY from the data).
        score = -self.compute_score(model, x_perturbed, model_kwargs)
        target = -noise / (self.noise_scale**2)
        loss = 0.5 * jnp.mean(
            jnp.sum(jnp.square(score - target).reshape(x.shape[0], -1), axis=-1)
        )
        return self.add_regularization(loss, model, x, model_kwargs)


@struct.dataclass
class SlicedScoreMatching(BaseScoreMatching):
    r"""Song et al. (2019) sliced score matching via random projections
    (reference ``score_matching.py:373-597``).

    .. math::
        \mathbb E_v\,\Big[ v^\top \nabla_x (v^\top s(x)) + \tfrac12 (v^\top s(x))^2 \Big]

    with ``n_projections`` draws of rademacher/sphere/gaussian vectors tiled
    over the batch. Unconditional only (the projection tiling cannot carry
    per-sample conditioning — same as the reference).
    """

    model: Energy = None
    n_projections: int = struct.field(pytree_node=False, default=5)
    projection_type: str = struct.field(pytree_node=False, default="rademacher")
    regularization_strength: float = struct.field(pytree_node=False, default=0.0)
    custom_regularization: Optional[Callable] = struct.field(pytree_node=False, default=None)

    def __post_init__(self):
        if self.projection_type not in ("rademacher", "sphere", "gaussian"):
            raise ValueError(
                f"projection_type must be rademacher/sphere/gaussian, got {self.projection_type!r}"
            )

    def _projections(self, key: Array, shape, dtype) -> Array:
        v = jax.random.normal(key, shape, dtype)
        if self.projection_type == "rademacher":
            return jnp.sign(v)
        if self.projection_type == "sphere":
            norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
            return v / jnp.maximum(norm, 1e-12) * math.sqrt(shape[-1])
        return v

    def __call__(self, params, x, key, *, model_kwargs=None):
        if model_kwargs:
            raise NotImplementedError(
                "Conditional sliced score matching is not supported (the "
                "projection tiling expands the batch); use "
                "DenoisingScoreMatching for conditional training."
            )
        model = self._model(params)
        batch = x.shape[0]
        dup_x = jnp.tile(x.reshape(batch, -1), (self.n_projections, 1))
        v = self._projections(key, dup_x.shape, x.dtype)

        def logp_sum(xx):
            return jnp.sum(-model.energy(xx.reshape(-1, *x.shape[1:])))

        # One forward-over-reverse pass yields the score AND the
        # Hessian-vector product Hv (H symmetric, so jvp of the score along v
        # equals the reference's second create_graph backward,
        # ``score_matching.py:540-559``) — 2 differentiation passes, not 3.
        grad1, hvp = jax.jvp(jax.grad(logp_sum), (dup_x,), (v,))
        v_score = jnp.sum(grad1 * v, axis=-1)
        term1 = 0.5 * jnp.square(v_score)
        term2 = jnp.sum(v * hvp, axis=-1)

        term1 = jnp.mean(term1.reshape(self.n_projections, -1), axis=0)
        term2 = jnp.mean(term2.reshape(self.n_projections, -1), axis=0)
        loss = jnp.mean(term1 + term2)
        return self.add_regularization(loss, model, x, model_kwargs)
