r"""Energy Matching (EM) loss (Balcerak et al. 2025).

Reference: ``torchebm/losses/energy_matching.py:73-484``. Trains a
time-independent scalar potential :math:`V_\theta` with two terms:

- **flow term**: :math:`w(t)\,\|{-\nabla V(x_t)} - u_t\|^2` on OT-coupled
  pairs, with smoothing noise σ and the time gate
  :math:`w(t) = \mathrm{clip}((1-t)/(1-a), 0, 1)`;
- **contrastive term**: :math:`\lambda_{cd}\,(\mathbb E[V(x)] -
  \mathrm{trimmed\_mean}(V(x^-)))` floored at :math:`-c_{clamp}`, with
  negatives from two Langevin populations — a ``noise_fraction`` of chains
  sweeping the Energy-Matching temperature profile :math:`\epsilon(t): 0 \to
  \epsilon_{max}`, the rest starting at data and held at
  :math:`\sqrt{\epsilon_{max}}` (reference ``:291-374``).

Two-phase training = flipping ``lambda_cd`` (0 for warm-up; the branch is
resolved at trace time, so each phase compiles its own program — the warm-up
program contains no Langevin chains at all, like the reference skips them).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import (
    BaseScheduler,
    ConstantScheduler,
    TemperatureScheduler,
    sched_init,
)
from ..couplings import BaseCoupling, resolve_coupling
from ..interpolants import BaseInterpolant, resolve_interpolant
from ..samplers.langevin import LangevinDynamics
from .base import BaseLoss, inject_params
from .loss_utils import compute_flow_weight, mean_flat, trimmed_mean

Array = jax.Array

__all__ = ["EnergyMatchingLoss"]


@struct.dataclass
class EnergyMatchingLoss(BaseLoss):
    """EM training loss. ``__call__(params, x1, key, x0=None, ...)`` → scalar;
    :meth:`training_losses` → terms dict (loss / flow_loss / cd_loss /
    cd_value / negatives)."""

    model: Energy = None
    sampler: Optional[LangevinDynamics] = None
    coupling: BaseCoupling = "ot"
    interpolant: BaseInterpolant = "linear"
    sigma: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=0.1)
    flow_weight_cutoff: float = struct.field(pytree_node=False, default=0.8)
    lambda_cd: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=2.0)
    epsilon_max: float = struct.field(pytree_node=False, default=0.15)
    tau_star: float = struct.field(pytree_node=False, default=0.8)
    n_langevin_steps: int = struct.field(pytree_node=False, default=200)
    langevin_dt: float = struct.field(pytree_node=False, default=0.01)
    noise_fraction: float = struct.field(pytree_node=False, default=0.5)
    cd_trim_fraction: float = struct.field(pytree_node=False, default=0.1)
    cd_clamp: Optional[float] = struct.field(pytree_node=False, default=0.02)

    def __post_init__(self):
        if not 0.0 <= self.noise_fraction <= 1.0:
            raise ValueError(f"noise_fraction must be in [0, 1], got {self.noise_fraction}")
        if not 0.0 <= self.cd_trim_fraction < 1.0:
            raise ValueError(f"cd_trim_fraction must be in [0, 1), got {self.cd_trim_fraction}")
        if self.cd_clamp is not None and self.cd_clamp < 0:
            raise ValueError(f"cd_clamp must be >= 0 or None, got {self.cd_clamp}")
        if self.langevin_dt <= 0:
            raise ValueError(f"langevin_dt must be positive, got {self.langevin_dt}")
        object.__setattr__(self, "coupling", resolve_coupling(self.coupling, default="ot"))
        object.__setattr__(
            self, "interpolant", resolve_interpolant(self.interpolant, default="linear")
        )
        if self.sampler is None:
            object.__setattr__(
                self,
                "sampler",
                LangevinDynamics(model=self.model, step_size=self.langevin_dt),
            )

    # -------------------------------------------------------------- pieces

    @property
    def _noise_sweep(self) -> TemperatureScheduler:
        """ε(t)-sweeping noise schedule for source-initialized chains."""
        return TemperatureScheduler(
            epsilon_max=self.epsilon_max,
            tau_star=self.tau_star,
            n_steps=self.n_langevin_steps,
            t_end=1.0,
        )

    @property
    def _noise_const(self) -> ConstantScheduler:
        """Constant √ε_max schedule for data-initialized chains."""
        return ConstantScheduler(math.sqrt(self.epsilon_max))

    @staticmethod
    def _slice_kwargs(mk: Dict[str, Any], idx, batch: int) -> Dict[str, Any]:
        return {
            k: (v[idx] if hasattr(v, "shape") and v.shape[:1] == (batch,) else v)
            for k, v in mk.items()
        }

    def _sample_negatives(self, params, x1, x0, key, model_kwargs):
        """Two Langevin populations under stop-grad (reference ``:291-374``).

        Returns ``(negatives, neg_model_kwargs)`` with conditioning aligned to
        the concatenated populations.
        """
        mk = model_kwargs or {}
        batch = x1.shape[0]
        n_noise = int(round(batch * self.noise_fraction))
        k_init, k_chain1, k_perm, k_chain2 = jax.random.split(key, 4)

        sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))
        negatives = []
        parts = []

        if n_noise > 0:
            mk_noise = self._slice_kwargs(mk, jnp.arange(n_noise), batch)
            if x0 is None:
                init = jax.random.normal(k_init, (n_noise, *x1.shape[1:]), x1.dtype)
            else:
                init = x0[jax.random.permutation(k_init, x0.shape[0])[:n_noise]]
            sweep = sampler.replace(noise_scale=self._noise_sweep)
            negatives.append(
                sweep.sample(
                    k_chain1,
                    x=jax.lax.stop_gradient(init),
                    n_steps=self.n_langevin_steps,
                    model_kwargs=mk_noise,
                )
            )
            parts.append(mk_noise)
        if batch - n_noise > 0:
            idx = jax.random.permutation(k_perm, batch)[: batch - n_noise]
            mk_data = self._slice_kwargs(mk, idx, batch)
            const = sampler.replace(noise_scale=self._noise_const)
            negatives.append(
                const.sample(
                    k_chain2,
                    x=jax.lax.stop_gradient(x1[idx]),
                    n_steps=self.n_langevin_steps,
                    model_kwargs=mk_data,
                )
            )
            parts.append(mk_data)

        neg_mk = {
            k: (
                jnp.concatenate([p[k] for p in parts], axis=0)
                if hasattr(v, "shape") and v.shape[:1] == (batch,)
                else v
            )
            for k, v in mk.items()
        }
        return jax.lax.stop_gradient(jnp.concatenate(negatives, axis=0)), neg_mk

    # ---------------------------------------------------------------- loss

    def training_losses(
        self,
        params: Any,
        x1: Array,
        key: Array,
        x0: Optional[Array] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Array]:
        mk = model_kwargs or {}
        model = self._model(params)
        batch = x1.shape[0]
        k_x0, k_couple, k_t, k_smooth, k_neg = jax.random.split(key, 5)

        if x0 is None:
            x0 = jax.random.normal(k_x0, x1.shape, x1.dtype)
        elif x0.shape != x1.shape:
            raise ValueError(f"x0 shape {x0.shape} must match x1 shape {x1.shape}")

        coupled = self.coupling(x0, x1, key=k_couple, **mk)
        x0c, x1c = coupled.x0, coupled.x1
        t = jax.random.uniform(k_t, (batch,), x1.dtype)
        xt, ut = self.interpolant.interpolate(x0c, x1c, t)

        sigma = sched_init(self.sigma)
        if sigma > 0:
            xt = xt + sigma * jax.random.normal(k_smooth, xt.shape, xt.dtype)
        xt = jax.lax.stop_gradient(xt)

        grad = jax.grad(lambda xx: jnp.sum(model.energy(xx, **mk)))(xt)
        w = compute_flow_weight(t, cutoff=self.flow_weight_cutoff)
        per_pair = w * mean_flat(jnp.square(-grad - ut))
        if coupled.weights is not None:
            flow_loss = jnp.sum(coupled.weights * per_pair) / jnp.maximum(
                jnp.sum(coupled.weights), 1e-12
            )
        else:
            flow_loss = jnp.mean(per_pair)

        terms: Dict[str, Array] = {"flow_loss": flow_loss}

        lambda_cd = sched_init(self.lambda_cd)
        if lambda_cd > 0:
            negatives, neg_mk = self._sample_negatives(params, x1, x0, k_neg, mk)
            pos_energy = model.energy(x1, **mk)
            neg_energy = model.energy(negatives, **neg_mk)
            cd_value = jnp.mean(pos_energy) - trimmed_mean(neg_energy, self.cd_trim_fraction)
            cd_loss = lambda_cd * cd_value
            if self.cd_clamp is not None:
                cd_loss = jnp.maximum(cd_loss, -self.cd_clamp)
            terms["cd_value"] = cd_value
            terms["negatives"] = negatives
        else:
            cd_loss = jnp.zeros((), flow_loss.dtype)

        terms["cd_loss"] = cd_loss
        terms["loss"] = flow_loss + cd_loss
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
        return self.training_losses(params, x, key, x0=x0, model_kwargs=model_kwargs)["loss"]
