r"""Model wrappers: CFG, pairwise-repulsion interaction, EqM-field → energy adapter.

Reference: ``torchebm/models/wrappers.py:11-278``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value

Array = jax.Array

__all__ = ["LabelClassifierFreeGuidance", "InteractionModel", "EqMEnergy"]


@struct.dataclass
class LabelClassifierFreeGuidance:
    """Classifier-free guidance wrapper (reference ``wrappers.py:11-55``).

    ``base`` is any ``model(x, t, y=..., **kw) -> (B, C, H, W)`` callable
    (e.g. a :class:`~torchebm_tpu.samplers.flow.WrappedField` over a DiT).
    Two forwards (conditional + null label) guide the first
    ``guide_channels`` channels. ``cfg_scale <= 1`` short-circuits to the
    conditional pass.
    """

    base: Any = None
    null_label_id: int = struct.field(pytree_node=False, default=0)
    cfg_scale: float = struct.field(pytree_node=False, default=1.0)
    guide_channels: int = struct.field(pytree_node=False, default=3)

    def __post_init__(self):
        from ..samplers.flow import WrappedField

        # Bare callables are not valid pytree leaves under jit; wrap them the
        # same way FlowSampler/EqMEnergy do (fn static, params a leaf).
        if callable(self.base) and not hasattr(self.base, "__dataclass_fields__"):
            object.__setattr__(self, "base", WrappedField(fn=self.base))

    def __call__(self, x: Array, t: Array, *, y: Array, **kwargs) -> Array:
        if self.cfg_scale <= 1.0:
            return self.base(x, t, y=y, **kwargs)
        y_null = jnp.full_like(y, self.null_label_id)
        cond = self.base(x, t, y=y, **kwargs)
        uncond = self.base(x, t, y=y_null, **kwargs)
        c = min(self.guide_channels, cond.shape[1])
        guided = uncond[:, :c] + self.cfg_scale * (cond[:, :c] - uncond[:, :c])
        if c == cond.shape[1]:
            return guided
        return jnp.concatenate([guided, uncond[:, c:]], axis=1)


@struct.dataclass
class InteractionModel(Energy):
    r"""Potential with pairwise repulsion for diverse sampling
    (reference ``wrappers.py:58-161``; Balcerak et al. 2025).

    .. math::
        E_i = V(x_i) - \tfrac12 \frac{s}{\sigma_W^2} \sum_j \|x_i - x_j\|^2

    The squared-distance sum uses the exact :math:`O(B d)` expansion
    :math:`B\|x_i\|^2 + \sum_j \|x_j\|^2 - 2 x_i \cdot \sum_j x_j` (cdist has a
    NaN derivative on the zero diagonal). ``strength`` is schedulable: the
    samplers thread their step index to step-aware energies (``wants_step``),
    so a ``TemperatureScheduler(..., sqrt=False)`` reproduces the paper's
    :math:`\epsilon(t)`-scaled interaction in lockstep with the noise schedule.

    Stability: the repulsive drift scales as :math:`2 s B / \sigma_W^2\,(x_i -
    \bar x)`; keep :math:`2 s B \Delta t / \sigma_W^2 \ll 1`.
    """

    model: Energy = None
    sigma_w: float = struct.field(pytree_node=False, default=1.0)
    strength: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=1.0)

    wants_step = True

    def __post_init__(self):
        if self.sigma_w <= 0:
            raise ValueError(f"sigma_w must be positive, got {self.sigma_w}")

    def energy(self, x: Array, step=None, **model_kwargs) -> Array:
        s = sched_value(self.strength, 0 if step is None else step)
        batch = x.shape[0]
        flat = x.reshape(batch, -1)
        sq_norms = jnp.sum(flat * flat, axis=1)
        pair_sq = batch * sq_norms + jnp.sum(sq_norms) - 2.0 * flat @ jnp.sum(flat, axis=0)
        w = 0.5 * (s / self.sigma_w**2) * pair_sq
        return self.model.energy(x, **model_kwargs) - w


@struct.dataclass
class EqMEnergy(Energy):
    r"""Scalar-energy adapter for trained Equilibrium-Matching fields
    (reference ``wrappers.py:164-278``).

    Turns a vector field ``field(x, t, **kw)`` into a scalar :class:`Energy`
    consumable by the MCMC/GD samplers. Always evaluates the field at
    :math:`t = 0` (EqM time invariance). Modes mirror
    :class:`~torchebm_tpu.losses.EquilibriumMatchingLoss`:

    - ``"dot"`` / ``"mean"``: :math:`g(x) = x \cdot f(x)`
    - ``"l2"``: :math:`g(x) = -\tfrac12 \|f(x)\|^2`
    - ``"implicit"``: :meth:`gradient` returns :math:`f(x, 0)` directly;
      :meth:`energy` returns the :math:`x \cdot f` surrogate for diagnostics.

    Descending this energy transports noise → data (EqM fields point
    data → noise, same direction as ``FlowSampler(negate_velocity=True)``).
    """

    field: Any = None
    energy_type: str = struct.field(pytree_node=False, default="dot")

    def __post_init__(self):
        if self.energy_type not in ("dot", "mean", "l2", "implicit"):
            raise ValueError(
                f"energy_type must be one of ['dot', 'implicit', 'l2', 'mean'], "
                f"got {self.energy_type!r}"
            )
        from ..samplers.flow import WrappedField

        if callable(self.field) and not hasattr(self.field, "__dataclass_fields__"):
            object.__setattr__(self, "field", WrappedField(fn=self.field))

    @classmethod
    def from_loss(cls, loss) -> "EqMEnergy":
        """Build the adapter matching a loss's ``energy_type`` (none → implicit)."""
        energy_type = "implicit" if loss.energy_type == "none" else loss.energy_type
        return cls(field=loss.model, energy_type=energy_type)

    def _field(self, x: Array, **model_kwargs) -> Array:
        t0 = jnp.zeros(x.shape[0], x.dtype)
        out = self.field(x, t0, **model_kwargs)
        if isinstance(out, tuple):
            out = out[0]
        return out

    def energy(self, x: Array, **model_kwargs) -> Array:
        f = self._field(x, **model_kwargs)
        if self.energy_type == "l2":
            return -0.5 * jnp.sum(jnp.square(f).reshape(x.shape[0], -1), axis=-1)
        return jnp.sum((x * f).reshape(x.shape[0], -1), axis=-1)

    def gradient(self, x: Array, **model_kwargs) -> Array:
        if self.energy_type == "implicit":
            return self._field(x, **model_kwargs)
        return super().gradient(x, **model_kwargs)
