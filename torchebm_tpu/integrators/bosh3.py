r"""Bogacki–Shampine 3(2) adaptive integrator with FSAL.

Reference: ``torchebm/integrators/bosh3.py:8-140``; Bogacki & Shampine (1989).
"""

from __future__ import annotations

from typing import ClassVar, Optional, Tuple

from ..core import struct

from .base import BaseRungeKuttaIntegrator

__all__ = ["Bosh3Integrator"]


@struct.dataclass
class Bosh3Integrator(BaseRungeKuttaIntegrator):
    r"""3-stage, 3rd-order method with embedded 2nd-order solution and FSAL.

    3rd-order weights :math:`b = (\tfrac29, \tfrac13, \tfrac49)`; embedded
    :math:`\hat b = (\tfrac7{24}, \tfrac14, \tfrac13, \tfrac18)` where the 4th
    entry is the FSAL evaluation at the accepted point.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = (
        (),
        (1 / 2,),
        (0.0, 3 / 4),
    )
    tableau_b: ClassVar[Tuple[float, ...]] = (2 / 9, 1 / 3, 4 / 9)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 1 / 2, 3 / 4)
    error_weights: ClassVar[Optional[Tuple[float, ...]]] = (
        2 / 9 - 7 / 24,
        1 / 3 - 1 / 4,
        4 / 9 - 1 / 3,
        -1 / 8,
    )
    order: ClassVar[Optional[int]] = 3
    fsal: ClassVar[bool] = True
