r"""Deterministic mode-seeking samplers: gradient descent and Nesterov.

Reference: ``torchebm/samplers/gradient_descent.py:16-275``.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from ..ops import FUSED_MODES
from .base import BaseSampler

Array = jax.Array

__all__ = ["GradientDescentSampler", "NesterovSampler"]


@struct.dataclass
class GradientDescentSampler(BaseSampler):
    r"""Deterministic energy minimization :math:`x_{k+1} = x_k - \eta \nabla E(x_k)`
    (reference ``gradient_descent.py:16-137``).

    Deterministic descent is exactly the whole-chain Langevin kernel at
    ``noise_scale = 0``, so eager GPU calls on the analytic targets that
    :class:`~torchebm_tpu.samplers.langevin.LangevinDynamics` runs as one
    kernel take the same kernel (same ``fused`` contract, seed-independent
    result). ``fused="off"`` pins the compiled scan.
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    fused: str = struct.field(pytree_node=False, default="auto")

    def __post_init__(self):
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {self.fused!r}")

    def step(self, carry, i, key, model_kwargs):
        del key
        eta = sched_value(self.step_size, i)
        x = carry["x"]
        return {"x": x - eta * self.gradient_of(x, model_kwargs, step=i)}

    # ------------------------------------------------------ fused fast path

    def _isotropic_gaussian_scale(self):
        from .langevin import _isotropic_scale

        return _isotropic_scale(self.model)

    def _dispatch_row(self, key, x, model_kwargs):
        from .langevin import FUSED_DISPATCH, _fused_gates_ok

        if _fused_gates_ok(self, key, x, model_kwargs, schedulables=(self.step_size,)):
            for row in FUSED_DISPATCH:
                if type(self.model) is row.model_type and row.supports(self):
                    return row
        if self.fused == "force":
            raise ValueError("fused='force': this call cannot run as one kernel")
        return None

    def sample(
        self,
        key,
        x=None,
        dim=None,
        n_steps: int = 100,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs=None,
    ):
        from .langevin import _call_fused_row, _sched_table_arg

        row = self._dispatch_row(key, x, model_kwargs)
        if row is not None:
            key_init, _ = jax.random.split(key)
            x0 = self._init_state(key_init, x, dim, n_samples)
            kargs = row.kernel_kwargs(self, x0)
            if kargs is not None and (
                not (return_trajectory or return_diagnostics)
                or n_steps // thin >= 1
            ):
                return _call_fused_row(
                    row,
                    x0,
                    self.model,
                    n_steps=n_steps,
                    thin=thin,
                    return_trajectory=return_trajectory,
                    return_diagnostics=return_diagnostics,
                    kargs=kargs,
                    step_size=_sched_table_arg(self.step_size, n_steps),
                    noise_scale=0.0,
                    seed=0,
                    clamp=None,
                )
            # unsupported state shape / n_steps < thin: fall back to the scan
        return super().sample(
            key,
            x=x,
            dim=dim,
            n_steps=n_steps,
            n_samples=n_samples,
            thin=thin,
            return_trajectory=return_trajectory,
            return_diagnostics=return_diagnostics,
            model_kwargs=model_kwargs,
        )


@struct.dataclass
class NesterovSampler(BaseSampler):
    r"""Nesterov accelerated gradient descent (reference ``gradient_descent.py:141-275``).

    .. math::
        v_{k+1} = \mu v_k - \eta \nabla E(x_k + \mu v_k), \qquad
        x_{k+1} = x_k + v_{k+1}
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    momentum: float = struct.field(pytree_node=False, default=0.9)

    def __post_init__(self):
        if not (0 <= self.momentum < 1):
            raise ValueError("momentum must be in [0, 1)")

    def init_carry(self, x0, key, model_kwargs):
        return {"x": x0, "v": jnp.zeros_like(x0)}

    def step(self, carry, i, key, model_kwargs):
        del key
        eta = sched_value(self.step_size, i)
        x, v = carry["x"], carry["v"]
        lookahead = x + self.momentum * v
        grad = self.gradient_of(lookahead, model_kwargs, step=i)
        v = self.momentum * v - eta * grad
        return {"x": x + v, "v": v}

