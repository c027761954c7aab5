"""torchebm-tpu: a JAX energy-based / simulation-free generative modeling framework.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
``soran-ghaderi/torchebm`` (see /root/reference). The organizing idea is the same
six composable axes (reference ``README.md:39-60``):

- **energy / field**   (:mod:`torchebm_tpu.core.energies`, :mod:`torchebm_tpu.models`)
- **interpolant**      (:mod:`torchebm_tpu.interpolants`)
- **coupling**         (:mod:`torchebm_tpu.couplings`)
- **objective**        (:mod:`torchebm_tpu.losses`)
- **sampler**          (:mod:`torchebm_tpu.samplers`)
- **integrator**       (:mod:`torchebm_tpu.integrators`)

but the execution model is JAX's: components are immutable pytrees
(:mod:`torchebm_tpu.core.struct`), sampling chains compile to single XLA
programs via ``lax.scan``/``lax.while_loop``, randomness is explicit
``jax.random`` key threading, distribution is ``jax.sharding.Mesh`` +
``NamedSharding``, and the Langevin chain on analytic targets has a GPU
kernel (:mod:`torchebm_tpu.ops`).

Subpackages lazy-load via module ``__getattr__`` (mirrors reference
``torchebm/__init__.py:40-47``).
"""

from __future__ import annotations

import importlib

__version__ = "0.5.0"

_SUBMODULES = (
    "core",
    "integrators",
    "interpolants",
    "couplings",
    "samplers",
    "losses",
    "models",
    "datasets",
    "ops",
    "parallel",
    "utils",
)

# name -> submodule path for lazily re-exported symbols
_LAZY_SYMBOLS = {
    # core
    "Energy": "core",
    "WrappedEnergy": "core",
    "as_energy": "core",
    "DoubleWellEnergy": "core",
    "GaussianEnergy": "core",
    "GaussianMixtureEnergy": "core",
    "HarmonicEnergy": "core",
    "RosenbrockEnergy": "core",
    "AckleyEnergy": "core",
    "RastriginEnergy": "core",
    "BaseScheduler": "core",
    "ConstantScheduler": "core",
    "ExponentialDecayScheduler": "core",
    "LinearScheduler": "core",
    "CosineScheduler": "core",
    "MultiStepScheduler": "core",
    "WarmupScheduler": "core",
    "TemperatureScheduler": "core",
    "sched_value": "core",
    "sched_init": "core",
    # integrators
    "get_integrator": "integrators",
    "resolve_integrator": "integrators",
    "EulerMaruyamaIntegrator": "integrators",
    "BackwardEulerMaruyamaIntegrator": "integrators",
    "HeunIntegrator": "integrators",
    "MidpointIntegrator": "integrators",
    "RK4Integrator": "integrators",
    "RK438Integrator": "integrators",
    "AdaptiveHeunIntegrator": "integrators",
    "Bosh3Integrator": "integrators",
    "Dopri5Integrator": "integrators",
    "Dopri8Integrator": "integrators",
    "LeapfrogIntegrator": "integrators",
    "GeneralisedLeapfrogIntegrator": "integrators",
    # interpolants
    "LinearInterpolant": "interpolants",
    "CosineInterpolant": "interpolants",
    "VariancePreservingInterpolant": "interpolants",
    "get_interpolant": "interpolants",
    "resolve_interpolant": "interpolants",
    "expand_t_like_x": "interpolants",
    # couplings
    "CouplingResult": "couplings",
    "IndependentCoupling": "couplings",
    "SinkhornCoupling": "couplings",
    "UnbalancedSinkhornCoupling": "couplings",
    "ExactOTCoupling": "couplings",
    "GreedyCoupling": "couplings",
    "ReflowCoupling": "couplings",
    "get_coupling": "couplings",
    "resolve_coupling": "couplings",
    # samplers
    "LangevinDynamics": "samplers",
    "MetropolisAdjustedLangevin": "samplers",
    "NoUTurnSampler": "samplers",
    "AISResult": "samplers",
    "annealed_importance_sampling": "samplers",
    "HamiltonianMonteCarlo": "samplers",
    "RiemannianManifoldHMC": "samplers",
    "GradientDescentSampler": "samplers",
    "NesterovSampler": "samplers",
    "FlowSampler": "samplers",
    "PredictionType": "samplers",
    "ParallelTemperingLangevin": "samplers",
    "TrajectoryTuning": "samplers",
    "tune_trajectory_length": "samplers",
    # losses
    "ContrastiveDivergence": "losses",
    "ParallelTemperingCD": "losses",
    "ScoreMatching": "losses",
    "DenoisingScoreMatching": "losses",
    "SlicedScoreMatching": "losses",
    "EquilibriumMatchingLoss": "losses",
    "EnergyMatchingLoss": "losses",
}

__all__ = list(_SUBMODULES) + list(_LAZY_SYMBOLS) + ["__version__"]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_SYMBOLS:
        mod = importlib.import_module(f".{_LAZY_SYMBOLS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
