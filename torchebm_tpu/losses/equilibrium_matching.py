r"""Equilibrium Matching (EqM) loss (Wang & Du 2025).

Reference: ``torchebm/losses/equilibrium_matching.py:51-419``. Trains an
equilibrium field/energy by regressing onto the truncated-decay target
:math:`-u_t \cdot c(t)` with :math:`c(t) = \lambda \min(1, (1-t)/(1-a))`;
supports implicit (vector field) and explicit (dot / l2 / mean) energy
formulations, velocity/score/noise prediction with velocity/likelihood loss
weights, minibatch couplings, and the dispersive regularizer.

Model contract: ``model(x, t, **kwargs) -> field`` (same shape as ``x``), or
``(field, activations)`` when returning features for the dispersive term.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.schedulers import BaseScheduler, sched_init
from ..couplings import BaseCoupling, resolve_coupling
from ..interpolants import BaseInterpolant, expand_t_like_x, resolve_interpolant
from .base import BaseLoss
from .loss_utils import compute_eqm_ct, dispersive_loss, mean_flat

Array = jax.Array

__all__ = ["EquilibriumMatchingLoss"]


@struct.dataclass
class EquilibriumMatchingLoss(BaseLoss):
    """EqM training loss. ``__call__(params, x1, key, x0=None, model_kwargs=...)``
    returns the scalar loss; :meth:`training_losses` returns the terms dict."""

    model: Any = None
    prediction: str = struct.field(pytree_node=False, default="velocity")
    energy_type: str = struct.field(pytree_node=False, default="none")
    interpolant: BaseInterpolant = "linear"
    coupling: BaseCoupling = None
    loss_weight: Optional[str] = struct.field(pytree_node=False, default=None)
    train_eps: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=0.0)
    ct_threshold: float = struct.field(pytree_node=False, default=0.8)
    ct_multiplier: float = struct.field(pytree_node=False, default=4.0)
    apply_dispersion: bool = struct.field(pytree_node=False, default=False)
    dispersion_weight: float = struct.field(pytree_node=False, default=0.5)
    time_invariant: bool = struct.field(pytree_node=False, default=True)

    def __post_init__(self):
        if self.prediction not in ("velocity", "score", "noise"):
            raise ValueError(f"Unknown prediction type: {self.prediction!r}")
        if self.energy_type not in ("none", "dot", "l2", "mean"):
            raise ValueError(f"Unknown energy type: {self.energy_type!r}")
        if self.loss_weight not in (None, "velocity", "likelihood"):
            raise ValueError(f"Unknown loss_weight: {self.loss_weight!r}")
        object.__setattr__(
            self, "interpolant", resolve_interpolant(self.interpolant, default="linear")
        )
        object.__setattr__(
            self, "coupling", resolve_coupling(self.coupling, default="independent")
        )
        from ..samplers.flow import WrappedField

        if callable(self.model) and not hasattr(self.model, "__dataclass_fields__"):
            object.__setattr__(self, "model", WrappedField(fn=self.model))

    # ------------------------------------------------------------------

    def _call_model(self, model, xt, t, model_kwargs):
        t_model = jnp.zeros_like(t) if self.time_invariant else t
        return model(xt, t_model, **(model_kwargs or {}))

    def _explicit_energy(self, model, xt, t, model_kwargs):
        r"""Explicit energy :math:`g` and its input-gradient (reference ``:178-215``):
        ``dot``/``mean``: :math:`g(x) = x \cdot f(x)`; ``l2``:
        :math:`g(x) = -\tfrac12 \|f(x)\|^2`. One forward, differentiated
        through the model; per-sample energies and the raw field ride along
        as aux."""

        def g_sum(xx):
            out = self._call_model(model, xx, t, model_kwargs)
            if isinstance(out, tuple):
                out = out[0]
            if self.energy_type in ("dot", "mean"):
                energy = jnp.sum((xx * out).reshape(xx.shape[0], -1), axis=-1)
            else:  # l2
                energy = -0.5 * jnp.sum(jnp.square(out).reshape(xx.shape[0], -1), axis=-1)
            return jnp.sum(energy), (energy, out)

        grad, (energy, out) = jax.grad(g_sum, has_aux=True)(xt)
        return grad, energy, out

    def training_losses(
        self,
        params: Any,
        x1: Array,
        key: Array,
        x0: Optional[Array] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Array]:
        """Terms dict with 'loss' (per-sample), 'pred', 'weights', optional 'energy'."""
        mk = model_kwargs or {}
        model = self._model(params)
        batch = x1.shape[0]
        k_x0, k_couple, k_t = jax.random.split(key, 3)

        if x0 is None:
            x0 = jax.random.normal(k_x0, x1.shape, x1.dtype)
        elif x0.shape != x1.shape:
            raise ValueError(f"x0 shape {x0.shape} must match x1 shape {x1.shape}")

        coupled = self.coupling(x0, x1, key=k_couple, **mk)
        x0, x1c = coupled.x0, coupled.x1

        eps = sched_init(self.train_eps)
        t0, t1 = eps, 1.0 - eps
        t = jax.random.uniform(k_t, (batch,), x1.dtype) * (t1 - t0) + t0

        xt, ut = self.interpolant.interpolate(x0, x1c, t)
        ct = compute_eqm_ct(t, threshold=self.ct_threshold, multiplier=self.ct_multiplier)
        ct = ct.reshape(batch, *([1] * (xt.ndim - 1)))
        target = -ut * ct

        terms: Dict[str, Array] = {"weights": coupled.weights}

        act = None
        if self.prediction == "velocity":
            if self.energy_type == "none":
                out = self._call_model(model, xt, t, mk)
                if isinstance(out, tuple):
                    out, act = out
                terms["pred"] = out
                terms["loss"] = mean_flat(jnp.square(out - target))
            else:
                grad, energy, out = self._explicit_energy(model, xt, t, mk)
                terms["pred"] = out
                terms["loss"] = mean_flat(jnp.square(grad - target))
                terms["energy"] = energy
        else:
            out = self._call_model(model, xt, t, mk)
            if isinstance(out, tuple):
                out, act = out
            terms["pred"] = out
            te = expand_t_like_x(t, xt)
            _, drift_var = self.interpolant.compute_drift(xt, t)
            sigma_t, _ = self.interpolant.compute_sigma_t(te)
            if self.loss_weight == "velocity":
                weight = jnp.square(drift_var / sigma_t)
            elif self.loss_weight == "likelihood":
                weight = drift_var / jnp.square(sigma_t)
            else:
                weight = 1.0
            if self.prediction == "noise":
                terms["loss"] = mean_flat(weight * jnp.square(out - x0))
            else:  # score
                terms["loss"] = mean_flat(weight * jnp.square(out * sigma_t + x0))

        if self.apply_dispersion:
            feats = None
            if act is not None:
                feats = act[-1] if isinstance(act, (list, tuple)) and len(act) else act
            if feats is not None and not (isinstance(feats, (list, tuple))):
                terms["loss"] = terms["loss"] + self.dispersion_weight * dispersive_loss(feats)

        return terms

    def __call__(
        self,
        params: Any,
        x: Array,
        key: Array,
        x0: Optional[Array] = None,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Array:
        terms = self.training_losses(params, x, key, x0=x0, model_kwargs=model_kwargs)
        loss, weights = terms["loss"], terms.get("weights")
        if weights is not None:
            return jnp.sum(weights * loss) / jnp.maximum(jnp.sum(weights), 1e-12)
        return jnp.mean(loss)
