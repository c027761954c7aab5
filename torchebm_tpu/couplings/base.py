r"""Coupling contracts: pairing rules between noise and data minibatches.

Reference: ``torchebm/core/base_coupling.py:10-279``. A coupling pairs a
source batch :math:`x_0` with a target batch :math:`x_1` before interpolation;
cost-based families reorder/resample :math:`x_1` by (approximately) minimizing
the squared-Euclidean transport cost, model-induced families generate
:math:`x_1 = \Phi(x_0)`.

JAX translation notes: ``generator`` becomes an explicit ``key`` argument
(stochastic solvers require it; deterministic ones ignore it); "computed under
``no_grad``" becomes ``jax.lax.stop_gradient`` on the result; index machinery
is pure so every cost coupling is jittable and can run inside a compiled
training step (including on sharded batches, where the cost matrix triggers
XLA all-gathers automatically).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from ..core import struct

Array = jax.Array

__all__ = ["CouplingResult", "BaseCoupling", "BaseCostCoupling", "BaseModelCoupling"]


@struct.dataclass
class CouplingResult:
    """Unpacking-stable result container (reference ``base_coupling.py:10-50``).

    Iterates as ``(x0, x1)``; extras (per-pair ``weights`` for unbalanced OT)
    ride along as attributes without breaking ``x0, x1 = coupling(...)``.
    """

    x0: Array
    x1: Array
    weights: Optional[Array] = None

    def __iter__(self):
        return iter((self.x0, self.x1))


class BaseCoupling:
    """Abstract coupling. Subclasses implement :meth:`couple`."""

    def couple(
        self,
        x0: Array,
        x1: Optional[Array] = None,
        *,
        key: Optional[Array] = None,
        **kwargs: Any,
    ) -> CouplingResult:
        raise NotImplementedError

    def __call__(self, x0, x1=None, *, key=None, **kwargs) -> CouplingResult:
        return self.couple(x0, x1, key=key, **kwargs)

    @staticmethod
    def _check_batch(x0: Array, x1: Array) -> None:
        if x0.shape[0] != x1.shape[0]:
            raise ValueError(
                f"Coupling requires equal batch sizes, got {x0.shape[0]} and {x1.shape[0]}"
            )

    def _require_x1(self, x1: Optional[Array]) -> Array:
        if x1 is None:
            raise ValueError(
                f"{type(self).__name__} pairs against an existing target batch; "
                f"x1 must not be None"
            )
        return x1


class BaseCostCoupling(BaseCoupling):
    r"""Template for cost-minimizing couplings (reference ``base_coupling.py:146-227``).

    ``couple`` = validate → cost matrix (:meth:`compute_cost`, max-normalized
    squared Euclidean by default) → abstract :meth:`_solve` → reindex ``x1``.
    The ``x0`` order and marginal are always preserved.
    """

    def compute_cost(self, x0: Array, x1: Array, **kwargs: Any) -> Array:
        b = x0.shape[0]
        a = x0.reshape(b, -1)
        c = x1.reshape(b, -1)
        sq = (
            jnp.sum(a * a, axis=1)[:, None]
            + jnp.sum(c * c, axis=1)[None, :]
            - 2.0 * a @ c.T
        )
        cost = jnp.maximum(sq, 0.0)
        return cost / jnp.maximum(jnp.max(cost), 1e-12)

    def _solve(self, cost: Array, key: Optional[Array] = None) -> Array:
        raise NotImplementedError

    def couple(self, x0, x1=None, *, key=None, **kwargs) -> CouplingResult:
        x1 = self._require_x1(x1)
        self._check_batch(x0, x1)
        if x0.shape[0] == 1:
            return CouplingResult(jax.lax.stop_gradient(x0), jax.lax.stop_gradient(x1))
        cost = self.compute_cost(x0, x1, **kwargs)
        idx = self._solve(cost, key=key)
        return CouplingResult(
            jax.lax.stop_gradient(x0), jax.lax.stop_gradient(x1[idx])
        )


class BaseModelCoupling(BaseCoupling):
    r"""Template for model-induced couplings :math:`(x_0, \Phi(x_0))`
    (reference ``base_coupling.py:230-279``). Any incoming ``x1`` is ignored."""

    def _generate(self, x0: Array, key: Optional[Array] = None, **kwargs: Any) -> Array:
        raise NotImplementedError

    def couple(self, x0, x1=None, *, key=None, **kwargs) -> CouplingResult:
        x1_gen = self._generate(x0, key=key, **kwargs)
        return CouplingResult(
            jax.lax.stop_gradient(x0), jax.lax.stop_gradient(x1_gen)
        )
