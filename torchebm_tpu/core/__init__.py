"""Core contracts: energies, schedulers, and re-exported base classes.

The JAX analogue of ``torchebm/core/__init__.py:48-86``. Base classes
for integrators/interpolants/couplings live with their implementations (no
torch-style module registry is needed when everything is a pytree), but are
re-exported here for API parity.
"""

from .module import warn_once
from .energies import (
    AckleyEnergy,
    DoubleWellEnergy,
    Energy,
    GaussianEnergy,
    GaussianMixtureEnergy,
    HarmonicEnergy,
    RastriginEnergy,
    RosenbrockEnergy,
    WrappedEnergy,
    as_energy,
)
from .schedulers import (
    BaseScheduler,
    ConstantScheduler,
    CosineScheduler,
    ExponentialDecayScheduler,
    LinearScheduler,
    MultiStepScheduler,
    TemperatureScheduler,
    WarmupScheduler,
    sched_init,
    sched_value,
)

__all__ = [
    "warn_once",
    "Energy",
    "WrappedEnergy",
    "as_energy",
    "DoubleWellEnergy",
    "GaussianEnergy",
    "GaussianMixtureEnergy",
    "HarmonicEnergy",
    "RosenbrockEnergy",
    "AckleyEnergy",
    "RastriginEnergy",
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


def __getattr__(name):
    # Base-class re-exports for reference API parity (lazy to avoid import cycles).
    import importlib

    _FORWARDS = {
        # trainer lives in its own module (reference keeps it unexported from
        # core/__init__, base_trainer.py; we forward lazily for convenience)
        "BaseTrainer": "torchebm_tpu.core.trainer",
        "ContrastiveDivergenceTrainer": "torchebm_tpu.core.trainer",
        "TrainState": "torchebm_tpu.core.trainer",
        "BaseIntegrator": "torchebm_tpu.integrators",
        "BaseRungeKuttaIntegrator": "torchebm_tpu.integrators",
        "BaseSDERungeKuttaIntegrator": "torchebm_tpu.integrators",
        "BaseSymplecticIntegrator": "torchebm_tpu.integrators",
        "BaseInterpolant": "torchebm_tpu.interpolants",
        "expand_t_like_x": "torchebm_tpu.interpolants",
        "BaseCoupling": "torchebm_tpu.couplings",
        "BaseCostCoupling": "torchebm_tpu.couplings",
        "BaseModelCoupling": "torchebm_tpu.couplings",
        "CouplingResult": "torchebm_tpu.couplings",
        "BaseSampler": "torchebm_tpu.samplers",
        "BaseLoss": "torchebm_tpu.losses",
    }
    if name in _FORWARDS:
        return getattr(importlib.import_module(_FORWARDS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
