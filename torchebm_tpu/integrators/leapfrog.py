r"""Symplectic leapfrog (Störmer–Verlet) integrators: separable and generalised.

Reference: ``torchebm/integrators/leapfrog.py:10-493``. Differences in this JAX design:

- ``integrate`` is a ``lax.scan`` carrying ``(x, p, force)`` — the force at the
  end of one step is reused as the start force of the next, halving gradient
  evaluations per trajectory relative to the reference's per-step re-evaluation
  (``leapfrog.py:159-186``) while computing the identical composition.
- ``safe`` mode's clamp + ``nan_to_num`` are branch-free elementwise ops (the reference
  chose in-place ``nan_to_num_`` for the same sync-free reason,
  ``base_integrator.py:875-889``).
- The generalised (non-separable) variant solves its two implicit stages by
  Picard iteration in ``lax.fori_loop``.
"""

from __future__ import annotations

from typing import Callable, ClassVar, Dict, Optional, Union

import jax
import jax.numpy as jnp
from ..core import struct

from .base import BaseSymplecticIntegrator, State

Array = jax.Array
DriftFn = Callable[[Array, Array], Array]
HamiltonField = Callable[[Array, Array, Array], Array]

__all__ = ["LeapfrogIntegrator", "GeneralisedLeapfrogIntegrator"]


@struct.dataclass
class LeapfrogIntegrator(BaseSymplecticIntegrator):
    r"""Separable-Hamiltonian Störmer–Verlet (reference ``leapfrog.py:10-187``).

    One step with force :math:`F = -\nabla_x U` and (optional) mass :math:`M`:

    .. math::
        p_{1/2} = p + \tfrac h2 F(x), \qquad
        x' = x + h\, p_{1/2} / M, \qquad
        p' = p_{1/2} + \tfrac h2 F(x').
    """

    separable: ClassVar[bool] = True

    def _apply_mass(self, p_half: Array, mass, x: Array) -> Array:
        if mass is None:
            return p_half
        return p_half / self._broadcast_mass(mass, x)

    def step(
        self,
        state: State,
        step_size,
        mass=None,
        *,
        drift: DriftFn,
        safe: bool = False,
        t=None,
        force: Optional[Array] = None,
        **_,
    ) -> State:
        """One leapfrog step. ``force`` may carry a pre-computed F(x) to reuse."""
        x, p = state["x"], state["p"]
        t = jnp.asarray(0.0 if t is None else t, x.dtype)
        h = jnp.asarray(step_size, x.dtype)

        f = drift(x, t) if force is None else force
        if safe:
            f = self._safe_clamp(f)
        p_half = p + 0.5 * h * f
        x_new = x + h * self._apply_mass(p_half, mass, x)
        f_new = drift(x_new, t)
        if safe:
            f_new = self._safe_clamp(f_new)
        p_new = p_half + 0.5 * h * f_new
        if safe:
            x_new = jnp.nan_to_num(x_new, nan=0.0, posinf=self.SAFE_CLAMP, neginf=-self.SAFE_CLAMP)
            p_new = jnp.nan_to_num(p_new, nan=0.0, posinf=self.SAFE_CLAMP, neginf=-self.SAFE_CLAMP)
        # preserve the caller's state dtype: an f32 force (f32 model params)
        # must not promote a bf16 (x, p) carry out of the trajectory scan
        return {"x": x_new.astype(x.dtype), "p": p_new.astype(p.dtype), "force": f_new}

    def integrate(
        self,
        state: State,
        step_size,
        n_steps: int,
        mass=None,
        *,
        drift: DriftFn,
        safe: bool = False,
        **_,
    ) -> State:
        """n-step leapfrog trajectory as a single scan with force reuse."""
        if n_steps is None or n_steps <= 0:
            raise ValueError("n_steps must be positive")
        x, p = state["x"], state["p"]
        t = jnp.asarray(0.0, x.dtype)
        f0 = drift(x, t)
        if safe:
            f0 = self._safe_clamp(f0)

        def body(carry, _):
            xc, pc, fc = carry
            out = self.step(
                {"x": xc, "p": pc}, step_size, mass,
                drift=drift, safe=safe, force=fc,
            )
            return (out["x"], out["p"], out["force"]), None

        (x_f, p_f, _), _ = jax.lax.scan(body, (x, p, f0), None, length=n_steps)
        return {"x": x_f, "p": p_f}


@struct.dataclass
class GeneralisedLeapfrogIntegrator(BaseSymplecticIntegrator):
    r"""Generalised leapfrog for non-separable Hamiltonians (RMHMC setting).

    Reference ``leapfrog.py:195-493`` (Girolami & Calderhead 2011). With
    ``velocity`` :math:`= \partial H/\partial p` and ``force``
    :math:`= -\partial H/\partial x`:

    .. math::
        p_{1/2} &= p + \tfrac h2\, \text{force}(x, p_{1/2})
            \quad\text{(implicit)} \\
        x' &= x + \tfrac h2 \big[\text{velocity}(x, p_{1/2}) +
            \text{velocity}(x', p_{1/2})\big] \quad\text{(implicit)} \\
        p' &= p_{1/2} + \tfrac h2\, \text{force}(x', p_{1/2}).

    Both implicit stages are Picard-iterated ``solver_max_iter`` times in
    ``lax.fori_loop`` (sync-free; the reference's opt-in residual check costs a
    host sync there, none here).
    """

    separable: ClassVar[bool] = False

    solver_max_iter: int = struct.field(pytree_node=False, default=8)
    solver_tol: float = struct.field(pytree_node=False, default=1e-6)
    solver_check_every: int = struct.field(pytree_node=False, default=0)

    def __post_init__(self):
        if self.solver_max_iter < 1:
            raise ValueError("solver_max_iter must be >= 1")

    def _picard(self, init: Array, update: Callable[[Array], Array]) -> Array:
        if self.solver_check_every <= 0:
            return jax.lax.fori_loop(
                0, self.solver_max_iter - 1, lambda _, y: update(y), update(init)
            )

        def cond(carry):
            _, resid, it = carry
            return (it < self.solver_max_iter - 1) & (resid > self.solver_tol)

        def body(carry):
            y, _, it = carry
            y_next = update(y)
            resid = jnp.sqrt(jnp.mean(jnp.square(y_next - y)))
            return y_next, resid, it + 1

        y0 = update(init)
        # residual dtype must track the state dtype (f64 under enable_x64)
        y, _, _ = jax.lax.while_loop(cond, body, (y0, jnp.asarray(jnp.inf, y0.dtype), 0))
        return y

    def step(
        self,
        state: State,
        step_size,
        *,
        force: HamiltonField,
        velocity: HamiltonField,
        safe: bool = False,
        **_,
    ) -> State:
        x, p = state["x"], state["p"]
        t = jnp.asarray(0.0, x.dtype)
        h = jnp.asarray(step_size, x.dtype)

        def clamp(v):
            return self._safe_clamp(v) if safe else v

        # implicit momentum half-step: p½ = p + h/2 · force(x, p½)
        p_half = self._picard(p, lambda ph: p + 0.5 * h * clamp(force(x, ph, t)))
        # implicit trapezoidal position step:
        # x' = x + h/2 · [velocity(x, p½) + velocity(x', p½)]
        v0 = clamp(velocity(x, p_half, t))
        x_new = self._picard(
            x, lambda xn: x + 0.5 * h * (v0 + clamp(velocity(xn, p_half, t)))
        )
        # explicit momentum half-step
        p_new = p_half + 0.5 * h * clamp(force(x_new, p_half, t))
        if safe:
            x_new = jnp.nan_to_num(x_new, nan=0.0, posinf=self.SAFE_CLAMP, neginf=-self.SAFE_CLAMP)
            p_new = jnp.nan_to_num(p_new, nan=0.0, posinf=self.SAFE_CLAMP, neginf=-self.SAFE_CLAMP)
        return {"x": x_new, "p": p_new}

    def integrate(
        self,
        state: State,
        step_size,
        n_steps: int,
        *,
        force: HamiltonField,
        velocity: HamiltonField,
        safe: bool = False,
        **_,
    ) -> State:
        if n_steps is None or n_steps <= 0:
            raise ValueError("n_steps must be positive")

        def body(carry, _):
            out = self.step(carry, step_size, force=force, velocity=velocity, safe=safe)
            return {"x": out["x"], "p": out["p"]}, None

        final, _ = jax.lax.scan(
            body, {"x": state["x"], "p": state["p"]}, None, length=n_steps
        )
        return final
