r"""Explicit midpoint (RK2) ODE integrator.

Reference: ``torchebm/integrators/midpoint.py:8-62``.
"""

from __future__ import annotations

from typing import ClassVar, Tuple

from ..core import struct

from .base import BaseRungeKuttaIntegrator

__all__ = ["MidpointIntegrator"]


@struct.dataclass
class MidpointIntegrator(BaseRungeKuttaIntegrator):
    r"""Explicit midpoint rule, 2nd order ODE family.

    .. math::
        k_1 = f(x_n, t_n), \quad
        k_2 = f(x_n + \tfrac h2 k_1, t_n + \tfrac h2), \quad
        x_{n+1} = x_n + h k_2
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((), (0.5,))
    tableau_b: ClassVar[Tuple[float, ...]] = (0.0, 1.0)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 0.5)
