"""NUTS→HMC trajectory-length handoff (``tune_trajectory_length``).

Build addition with no reference counterpart (the reference ships neither
NUTS nor dual averaging; "HMC + dual-averaging" made turnkey). Batched NUTS
on SIMD hardware pays the **max** tree size across lockstep chains every
draw (a single depth-8 straggler makes all 256 chains pay 2⁸ leapfrog
leaves), so NUTS's dynamic trajectories are worth one *pilot*, not a
production run: use NUTS to find the trajectory length, then hand off to HMC
at ``n_leapfrog ≈ 2^mean_tree_depth`` for the production draws.

This module is that recipe as API::

    tuning = tune_trajectory_length(key, energy, dim=2, n_samples=256)
    hmc = HamiltonianMonteCarlo(
        energy,
        step_size=tuning.step_size,
        n_leapfrog_steps=tuning.n_leapfrog,
        mass=tuning.mass,
    )
    samples = hmc.sample(key2, x=tuning.x, n_steps=10_000)

Used by ``examples/10-sampling/sampler_shootout``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .hmc import HamiltonianMonteCarlo
from .nuts import NoUTurnSampler

Array = jax.Array

__all__ = ["TrajectoryTuning", "tune_trajectory_length"]


class TrajectoryTuning(NamedTuple):
    """Result of :func:`tune_trajectory_length` — plug straight into
    :class:`~torchebm_tpu.samplers.HamiltonianMonteCarlo`."""

    #: HMC trajectory length, ``max(2, round(2^mean_tree_depth))``.
    n_leapfrog: int
    #: dual-averaged step size re-adapted by HMC *at that trajectory length*
    #: (NUTS's adapted ε is a good init but not identical — HMC's acceptance
    #: statistic is a single end-point MH test, NUTS's a trajectory average).
    step_size: Array
    #: warmed chain states — start production sampling from these.
    x: Array
    #: mean NUTS tree depth over the pilot draws (doublings per transition).
    mean_tree_depth: float
    #: Stan-style diagonal mass matrix (``adapt_mass=True``) or None.
    mass: Optional[Array] = None


def tune_trajectory_length(
    key: Array,
    model,
    *,
    x: Optional[Array] = None,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    n_samples: int = 64,
    n_warmup: int = 200,
    n_pilot: int = 100,
    step_size: float = 0.2,
    max_tree_depth: int = 8,
    target_accept: float = 0.8,
    adapt_mass: bool = False,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> TrajectoryTuning:
    """Pilot NUTS → production-HMC handoff: find the trajectory length.

    Three phases, all compiled scans:

    1. **NUTS warmup** (``n_warmup`` dual-averaging transitions, optional
       Stan-style diagonal mass adaptation) — adapts ε for the target's
       geometry without hand-tuning.
    2. **NUTS pilot** (``n_pilot`` draws) — records the mean tree depth; the
       no-U-turn criterion is what actually *measures* how long trajectories
       should be on this target.
    3. **HMC warmup** at ``n_leapfrog = max(2, round(2^mean_tree_depth))`` —
       re-adapts ε for fixed-length HMC, whose per-draw cost is the fixed
       ``n_leapfrog`` gradient evaluations, not the across-chain max tree
       size.

    This is eager tuning code (one host sync to read the mean depth); run it
    once per target, not inside a jitted loop.
    """
    model_kwargs = model_kwargs or {}
    k_warm, k_pilot, k_hmc = jax.random.split(key, 3)
    nuts = NoUTurnSampler(
        model,
        step_size=step_size,
        max_tree_depth=max_tree_depth,
        target_accept=target_accept,
    )
    mass = None
    if adapt_mass:
        x0, eps, mass = nuts.warmup(
            k_warm, x=x, dim=dim, n_warmup=n_warmup, n_samples=n_samples,
            adapt_mass=True, model_kwargs=model_kwargs,
        )
        nuts = nuts.replace(step_size=eps, mass=mass)
    else:
        x0, eps = nuts.warmup(
            k_warm, x=x, dim=dim, n_warmup=n_warmup, n_samples=n_samples,
            model_kwargs=model_kwargs,
        )
        nuts = nuts.replace(step_size=eps)

    x1, diag = nuts.sample(
        k_pilot, x=x0, n_steps=n_pilot, return_diagnostics=True,
        model_kwargs=model_kwargs,
    )
    depth = float(jnp.mean(diag["tree_depth"]))
    n_leapfrog = max(2, int(round(2.0 ** depth)))

    hmc = HamiltonianMonteCarlo(
        model,
        step_size=float(eps),
        n_leapfrog_steps=n_leapfrog,
        mass=mass,
        dual_averaging=True,
        target_accept=target_accept,
    )
    x2, eps_hmc = hmc.warmup(
        k_hmc, x=x1, n_warmup=n_warmup, n_samples=n_samples,
        model_kwargs=model_kwargs,
    )
    return TrajectoryTuning(
        n_leapfrog=n_leapfrog,
        step_size=eps_hmc,
        x=x2,
        mean_tree_depth=depth,
        mass=mass,
    )
