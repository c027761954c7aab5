r"""Heun (trapezoidal, 2-stage) SDE integrator.

Reference: ``torchebm/integrators/heun.py:6-53``.
"""

from __future__ import annotations

from typing import ClassVar, Tuple

from ..core import struct

from .base import BaseSDERungeKuttaIntegrator

__all__ = ["HeunIntegrator"]


@struct.dataclass
class HeunIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Heun's trapezoidal predictor–corrector, order 2 deterministic part.

    .. math::
        k_1 = f(x_n, t_n), \quad k_2 = f(x_n + h k_1, t_n + h), \quad
        x_{n+1} = x_n + \tfrac h2 (k_1 + k_2) + \sqrt{2Dh}\,\varepsilon
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((), (1.0,))
    tableau_b: ClassVar[Tuple[float, ...]] = (0.5, 0.5)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 1.0)
