r"""Parallel-tempered Langevin dynamics (replica exchange).

The reference ships only a constructor stub for parallel tempering
(``torchebm/losses/contrastive_divergence.py:246-263`` — commented-out body
that runs per-temperature chains in a host Python loop and swaps one random
adjacent pair per sweep). This module implements the real thing:
the replica ladder is just **another batch axis** ``(R, B, *data_shape)``,
every temperature steps in the same fused XLA program, and the deterministic
even–odd adjacent-pair sweep (Okabe et al. 2001) makes all swap attempts
branch-free ``jnp.where`` selects.

Dynamics per replica :math:`r` with inverse temperature
:math:`\beta_r = 1/T_r` (stationary law :math:`\propto e^{-\beta_r U}`):

.. math::
    x_{t+1}^{(r)} = x_t^{(r)} - \eta\,\beta_r \nabla U(x_t^{(r)})
    + \text{noise\_scale}\cdot\sqrt{2\eta}\,\varepsilon_t

Every ``swap_every`` steps, adjacent pairs exchange states with the replica
exchange Metropolis probability
:math:`\min\!\big(1, e^{(\beta_r - \beta_{r+1})(U_r - U_{r+1})}\big)`,
independently per chain in the batch. Alternating even/odd pair phases keep
the attempts disjoint so they vectorize with no sequencing.

``sample()`` returns the **cold** (``temperatures[0]``) chain, which targets
the true model distribution; the hot replicas exist to ferry chains across
energy barriers (the multimodal-mixing failure mode of plain Langevin).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from .base import BaseSampler

Array = jax.Array

__all__ = ["ParallelTemperingLangevin"]


@struct.dataclass
class ParallelTemperingLangevin(BaseSampler):
    """Replica-exchange Langevin over a static temperature ladder.

    Args:
        model: The target :class:`~torchebm_tpu.core.energies.Energy`.
        temperatures: Strictly increasing ladder; ``temperatures[0]`` is the
            cold chain whose samples are returned (use ``1.0`` to target the
            unmodified model). A geometric ladder (ratio ~1.3–2) is standard.
        step_size / noise_scale: As in
            :class:`~torchebm_tpu.samplers.langevin.LangevinDynamics`
            (schedulable).
        swap_every: Attempt replica exchange every this many Langevin steps.
        clamp: Optional per-step state clamp (image-EBM stabilization).
    """

    model: Energy
    temperatures: Tuple[float, ...] = struct.field(
        pytree_node=False, default=(1.0, 1.6, 2.56, 4.1)
    )
    step_size: Union[float, BaseScheduler] = 1e-2
    noise_scale: Union[float, BaseScheduler] = 1.0
    swap_every: int = struct.field(pytree_node=False, default=5)
    clamp: Optional[Tuple[float, float]] = struct.field(pytree_node=False, default=None)

    def __post_init__(self):
        temps = tuple(float(t) for t in self.temperatures)
        if len(temps) < 2:
            raise ValueError("temperatures needs >= 2 entries for replica exchange")
        if any(t <= 0 for t in temps):
            raise ValueError(f"temperatures must be positive, got {temps}")
        if any(b >= a for b, a in zip(temps, temps[1:])):
            raise ValueError(f"temperatures must be strictly increasing, got {temps}")
        if self.swap_every < 1:
            raise ValueError("swap_every must be >= 1")
        if self.clamp is not None and self.clamp[0] >= self.clamp[1]:
            raise ValueError(f"clamp min must be < max, got {self.clamp}")
        object.__setattr__(self, "temperatures", temps)

    # ------------------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.temperatures)

    def _betas(self, dtype) -> Array:
        return 1.0 / jnp.asarray(self.temperatures, dtype)

    def _langevin_all(self, replicas: Array, i, key: Array, model_kwargs) -> Array:
        """One tempered Langevin step on every replica at once."""
        eta = sched_value(self.step_size, i)
        ns = sched_value(self.noise_scale, i)
        grad = jax.vmap(lambda xr: self.gradient_of(xr, model_kwargs, step=i))(replicas)
        betas = self._betas(replicas.dtype).reshape((-1,) + (1,) * (replicas.ndim - 1))
        noise = jax.random.normal(key, replicas.shape, replicas.dtype)
        new = replicas - eta * betas * grad + ns * jnp.sqrt(2.0 * eta) * noise
        if self.clamp is not None:
            new = jnp.clip(new, self.clamp[0], self.clamp[1])
        return new

    def _swap(self, replicas: Array, phase, key: Array, model_kwargs):
        """One even/odd sweep of adjacent-pair exchanges.

        ``phase`` is 0 (pairs 0–1, 2–3, …) or 1 (pairs 1–2, 3–4, …); attempts
        within a phase are disjoint, so the unrolled pair loop commutes.
        Returns ``(replicas, mean acceptance probability over attempted
        pairs)``.
        """
        energies = jax.vmap(lambda xr: self.energy_of(xr, model_kwargs))(replicas)
        betas = self._betas(energies.dtype)
        accs = []
        for r in range(self.n_replicas - 1):
            active = jnp.asarray((r % 2), jnp.int32) == phase
            u = jax.random.uniform(jax.random.fold_in(key, r), energies.shape[1:])
            delta = (betas[r] - betas[r + 1]) * (energies[r] - energies[r + 1])
            accept_prob = jnp.minimum(jnp.exp(jnp.clip(delta, -50.0, 50.0)), 1.0)
            do = active & (u < accept_prob)
            mask = do.reshape(do.shape + (1,) * (replicas.ndim - 2))
            lo, hi = replicas[r], replicas[r + 1]
            replicas = replicas.at[r].set(jnp.where(mask, hi, lo))
            replicas = replicas.at[r + 1].set(jnp.where(mask, lo, hi))
            # swapped states carry their energies along for later pairs
            e_lo, e_hi = energies[r], energies[r + 1]
            energies = energies.at[r].set(jnp.where(do, e_hi, e_lo))
            energies = energies.at[r + 1].set(jnp.where(do, e_lo, e_hi))
            accs.append(jnp.where(active, jnp.mean(accept_prob), jnp.nan))
        # mean over the pairs attempted this phase (NaN-skipping)
        acc = jnp.nanmean(jnp.stack(accs))
        return replicas, acc

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0: Array, key: Array, model_kwargs) -> Dict[str, Any]:
        replicas = jnp.broadcast_to(x0[None], (self.n_replicas,) + x0.shape)
        return {
            "x": x0,
            "replicas": replicas,
            "swap_accept": jnp.float32(0.0),
        }

    def step(self, carry, i, key, model_kwargs) -> Dict[str, Any]:
        k_lang, k_swap = jax.random.split(key)
        replicas = self._langevin_all(carry["replicas"], i, k_lang, model_kwargs)
        # With 2 replicas there is only one pair: attempt it every sweep
        # (an alternating phase would idle half the sweeps on NaN stats).
        sweep = i // self.swap_every
        phase = (sweep % 2) if self.n_replicas > 2 else jnp.int32(0)
        do_swap = (i % self.swap_every) == (self.swap_every - 1)

        def attempt(reps):
            return self._swap(reps, phase, k_swap, model_kwargs)

        replicas, acc = jax.lax.cond(
            do_swap, attempt, lambda reps: (reps, carry["swap_accept"]), replicas
        )
        return {"x": replicas[0], "replicas": replicas, "swap_accept": acc}

    def extra_diagnostics(self, carry, model_kwargs):
        return {"swap_acceptance_rate": carry["swap_accept"]}

    # ------------------------------------------------------------- replicas

    def run_replicas(
        self,
        key: Array,
        replicas: Array,
        n_steps: int,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Array, Array]:
        """Advance a full ``(n_replicas, B, *data_shape)`` ladder ``n_steps``.

        The persistence entry point (used by
        :class:`~torchebm_tpu.losses.ParallelTemperingCD` to keep every
        temperature's chain alive across training steps, which ``sample()``
        — cold-start, cold-return — cannot express). Returns
        ``(new_replicas, last swap acceptance)``.
        """
        replicas = jnp.asarray(replicas)
        if replicas.ndim < 2 or replicas.shape[0] != self.n_replicas:
            raise ValueError(
                f"replicas must be (n_replicas={self.n_replicas}, B, *data_shape); "
                f"got {replicas.shape}"
            )
        return _run_replicas_impl(self, replicas, key, n_steps, model_kwargs or {})


@partial(jax.jit, static_argnames=("n_steps",))
def _run_replicas_impl(sampler, replicas, key, n_steps, model_kwargs):
    carry0 = {
        "x": replicas[0],
        "replicas": replicas,
        "swap_accept": jnp.float32(0.0),
    }

    def body(i, carry):
        return sampler.step(carry, i, jax.random.fold_in(key, i), model_kwargs)

    carry = jax.lax.fori_loop(0, n_steps, body, carry0)
    return carry["replicas"], carry["swap_accept"]
