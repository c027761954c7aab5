r"""Step-indexed parameter schedules as pure functions.

JAX re-design of the reference scheduler family
(``torchebm/core/base_scheduler.py:73-969``). The reference schedulers are
mutable objects with ``step()``/``reset()``/``state_dict()``; their computed
values are all closed-form functions of ``step_count``, so here each scheduler
is an **immutable pytree** exposing ``value(step)`` where ``step`` may be a
traced ``int32`` scalar — which is exactly what lets samplers advance schedules
*inside* a ``lax.scan`` loop carry with zero host interaction.

Semantics contract (matches the reference's stepping convention): iteration
``i`` of a sampler loop uses ``value(i)``; ``value(0)`` is the start value.
State is just the integer step, so "checkpointing a scheduler" is
checkpointing one integer.

The reference's :class:`Schedulable` mixin (``core/schedulable.py:17-75``) —
"a parameter may be a float or a scheduler" — becomes :func:`sched_value`,
which evaluates either form at a given step.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import jax
import jax.numpy as jnp
from . import struct

Array = jax.Array
ScalarOrSchedule = Union[float, "BaseScheduler"]

__all__ = [
    "BaseScheduler",
    "ConstantScheduler",
    "ExponentialDecayScheduler",
    "LinearScheduler",
    "CosineScheduler",
    "MultiStepScheduler",
    "WarmupScheduler",
    "TemperatureScheduler",
    "sched_value",
    "sched_init",
]


class BaseScheduler:
    """Schedule contract: ``value(step) -> f32 scalar`` for integer (possibly traced) ``step``."""

    def value(self, step) -> Array:
        raise NotImplementedError

    def __call__(self, step) -> Array:
        return self.value(step)


def sched_value(param: ScalarOrSchedule, step) -> Array:
    """Evaluate a schedulable parameter (float or scheduler) at ``step``.

    The JAX form of the reference's ``Schedulable.get_scheduled_value``
    (``schedulable.py:44-52``).
    """
    if isinstance(param, BaseScheduler):
        return param.value(step)
    return jnp.asarray(param, dtype=jnp.float32)


def sched_init(param: ScalarOrSchedule) -> float:
    """Static (Python float) value of a schedulable parameter at step 0.

    Useful for shape/scale heuristics computed at trace time.
    """
    if isinstance(param, BaseScheduler):
        return float(param.value(0))
    return float(param)


@struct.dataclass
class ConstantScheduler(BaseScheduler):
    """:math:`v(t) = v_0` (reference ``base_scheduler.py:282-326``)."""

    start_value: float = struct.field(pytree_node=False)

    def value(self, step) -> Array:
        del step
        return jnp.float32(self.start_value)


@struct.dataclass
class ExponentialDecayScheduler(BaseScheduler):
    r""":math:`v(t) = \max(v_{min}, v_0 \gamma^t)` (reference ``base_scheduler.py:328-425``)."""

    start_value: float = struct.field(pytree_node=False)
    decay_rate: float = struct.field(pytree_node=False)
    min_value: float = struct.field(pytree_node=False, default=0.0)

    def __post_init__(self):
        if not 0.0 < self.decay_rate <= 1.0:
            raise ValueError(f"decay_rate must be in (0, 1], got {self.decay_rate}")
        if self.min_value < 0:
            raise ValueError(f"min_value must be non-negative, got {self.min_value}")

    def value(self, step) -> Array:
        step = jnp.asarray(step, jnp.float32)
        # decay^t as exp(t·log γ): stable and cheap elementwise.
        val = self.start_value * jnp.exp(step * math.log(self.decay_rate))
        return jnp.maximum(jnp.float32(self.min_value), val)


@struct.dataclass
class LinearScheduler(BaseScheduler):
    r"""Linear ramp from ``start_value`` to ``end_value`` over ``n_steps``, then hold
    (reference ``base_scheduler.py:427-521``)."""

    start_value: float = struct.field(pytree_node=False)
    end_value: float = struct.field(pytree_node=False)
    n_steps: int = struct.field(pytree_node=False)

    def __post_init__(self):
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be a positive integer, got {self.n_steps}")

    def value(self, step) -> Array:
        frac = jnp.clip(jnp.asarray(step, jnp.float32) / self.n_steps, 0.0, 1.0)
        return jnp.float32(self.start_value) + frac * (self.end_value - self.start_value)


@struct.dataclass
class CosineScheduler(BaseScheduler):
    r"""Cosine annealing from ``start_value`` to ``end_value`` over ``n_steps``, then hold
    (reference ``base_scheduler.py:523-625``)."""

    start_value: float = struct.field(pytree_node=False)
    end_value: float = struct.field(pytree_node=False)
    n_steps: int = struct.field(pytree_node=False)

    def __post_init__(self):
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be a positive integer, got {self.n_steps}")

    def value(self, step) -> Array:
        frac = jnp.clip(jnp.asarray(step, jnp.float32) / self.n_steps, 0.0, 1.0)
        cosine_factor = 0.5 * (1.0 + jnp.cos(math.pi * frac))
        return jnp.float32(self.end_value) + (self.start_value - self.end_value) * cosine_factor


@struct.dataclass
class MultiStepScheduler(BaseScheduler):
    r""":math:`v(t) = v_0 \gamma^{\#\{m_i \le t\}}` — milestone decay
    (reference ``base_scheduler.py:628-731``)."""

    start_value: float = struct.field(pytree_node=False)
    milestones: tuple = struct.field(pytree_node=False)
    gamma: float = struct.field(pytree_node=False, default=0.1)

    def __post_init__(self):
        ms = tuple(self.milestones)
        if not all(m > 0 for m in ms):
            raise ValueError("Milestone steps must be positive integers.")
        if not all(ms[i] < ms[i + 1] for i in range(len(ms) - 1)):
            raise ValueError("Milestones must be strictly increasing.")
        object.__setattr__(self, "milestones", ms)

    def value(self, step) -> Array:
        step = jnp.asarray(step, jnp.int32)
        ms = jnp.asarray(self.milestones, jnp.int32)
        power = jnp.sum(step >= ms).astype(jnp.float32)
        return self.start_value * jnp.exp(power * math.log(self.gamma))


@struct.dataclass
class WarmupScheduler(BaseScheduler):
    r"""Linear warmup into another schedule, driven in lockstep afterwards
    (reference ``base_scheduler.py:733-855``).

    ``value(t) = v_init + (v_target - v_init)·t/T`` for ``t <= T`` (with
    ``v_init = v_target·warmup_init_factor``, ``v_target`` = main schedule's
    start value), else ``main.value(t - T)``.
    """

    main_scheduler: BaseScheduler
    warmup_steps: int = struct.field(pytree_node=False)
    warmup_init_factor: float = struct.field(pytree_node=False, default=0.01)

    def value(self, step) -> Array:
        step = jnp.asarray(step, jnp.int32)
        target = self.main_scheduler.value(0)
        init = target * self.warmup_init_factor
        frac = jnp.asarray(step, jnp.float32) / max(self.warmup_steps, 1)
        warm = init + frac * (target - init)
        main = self.main_scheduler.value(jnp.maximum(step - self.warmup_steps, 0))
        return jnp.where(step <= self.warmup_steps, warm, main)


@struct.dataclass
class TemperatureScheduler(BaseScheduler):
    r"""Energy-Matching piecewise temperature profile :math:`\epsilon(t)`
    (reference ``base_scheduler.py:857-969``; Balcerak et al. 2025).

    .. math::
        \epsilon(t) = \begin{cases}
            0 & t < \tau^* \\
            \epsilon_{max}\,(t-\tau^*)/(1-\tau^*) & \tau^* \le t < 1 \\
            \epsilon_{max} & t \ge 1
        \end{cases}

    Step count maps to virtual time ``t = t_start + (t_end-t_start)·min(n,N)/N``.
    With ``sqrt=True`` the returned value is :math:`\sqrt{\epsilon(t)}` — a
    drop-in ``noise_scale`` for Langevin dynamics (integrator noise is
    ``noise_scale·sqrt(2·step_size)``, giving the paper's
    :math:`\sqrt{2\epsilon(t)\Delta t}\,\eta`).
    """

    epsilon_max: float = struct.field(pytree_node=False)
    tau_star: float = struct.field(pytree_node=False, default=0.8)
    n_steps: int = struct.field(pytree_node=False, default=200)
    t_start: float = struct.field(pytree_node=False, default=0.0)
    t_end: float = struct.field(pytree_node=False, default=1.0)
    sqrt: bool = struct.field(pytree_node=False, default=True)

    def __post_init__(self):
        if self.epsilon_max < 0:
            raise ValueError(f"epsilon_max must be >= 0, got {self.epsilon_max}")
        if not 0.0 <= self.tau_star < 1.0:
            raise ValueError(f"tau_star must be in [0, 1), got {self.tau_star}")
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {self.n_steps}")
        if self.t_end < self.t_start:
            raise ValueError(f"t_end ({self.t_end}) must be >= t_start ({self.t_start})")

    def epsilon_at(self, t) -> Array:
        r"""Raw temperature :math:`\epsilon(t)` at (possibly traced) virtual time ``t``."""
        t = jnp.asarray(t, jnp.float32)
        ramp = self.epsilon_max * (t - self.tau_star) / (1.0 - self.tau_star)
        return jnp.where(
            t < self.tau_star, 0.0, jnp.where(t < 1.0, ramp, self.epsilon_max)
        )

    def value(self, step) -> Array:
        frac = jnp.clip(jnp.asarray(step, jnp.float32) / self.n_steps, 0.0, 1.0)
        t = self.t_start + (self.t_end - self.t_start) * frac
        eps = self.epsilon_at(t)
        return jnp.sqrt(eps) if self.sqrt else eps
