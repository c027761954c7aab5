r"""Euler–Maruyama and drift-implicit (backward) Euler–Maruyama integrators.

Reference: ``torchebm/integrators/euler_maruyama.py:11-131``.
"""

from __future__ import annotations

from typing import ClassVar, Optional, Tuple

from ..core import struct

from .base import BaseSDERungeKuttaIntegrator

__all__ = ["EulerMaruyamaIntegrator", "BackwardEulerMaruyamaIntegrator"]


@struct.dataclass
class EulerMaruyamaIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Explicit Euler–Maruyama: :math:`x_{n+1} = x_n + h f(x_n,t_n) + \sqrt{2Dh}\,\varepsilon`.

    The workhorse SDE scheme (Langevin dynamics default; registry aliases
    ``"euler"`` and ``"euler_maruyama"``). Reference
    ``integrators/euler_maruyama.py:11-66``.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((),)
    tableau_b: ClassVar[Tuple[float, ...]] = (1.0,)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0,)


@struct.dataclass
class BackwardEulerMaruyamaIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Drift-implicit Euler–Maruyama (DIRK with :math:`a = [[1]]`), noise explicit.

    The implicit equation :math:`k = f(x + h k, t+h)` is solved by Picard
    iteration (``solver_max_iter`` fixed-point steps). Reference
    ``integrators/euler_maruyama.py:68-131``.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((1.0,),)
    tableau_b: ClassVar[Tuple[float, ...]] = (1.0,)
    tableau_c: ClassVar[Tuple[float, ...]] = (1.0,)
