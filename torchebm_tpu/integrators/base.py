r"""Integrator contracts: explicit/DIRK Runge-Kutta, SDE, and symplectic families.

JAX re-design of ``torchebm/core/base_integrator.py`` (889 LoC). The
reference steps a mutable state dict from host Python, caches tableau tensors
per device, and pays one ``.item()`` host sync per attempted adaptive step
(``base_integrator.py:481-483``). Here:

- Integrators are **frozen, array-free pytrees** (all fields static), so they
  hash into the jit cache and close over nothing mutable.
- Butcher tableaus are plain Python tuples baked into the trace — each step
  unrolls ``s`` stages into one fused XLA computation (the reference's einsum
  fusion at ``base_integrator.py:330-347`` happens automatically here).
- Fixed-grid ``integrate`` is a ``lax.scan``; the embedded-pair adaptive
  controller is a ``lax.while_loop`` with accept/reject **on device** — zero
  host syncs for the entire trajectory.
- DIRK implicit stages are solved by Picard iteration in ``lax.fori_loop``
  (sync-free fixed count) or ``lax.while_loop`` (residual early-exit — free in
  XLA, unlike the reference where each check costs a sync,
  ``base_integrator.py:377-384``).
- SDE noise is explicit ``jax.random`` key threading (the reference's
  ``generator`` contract, ``base_integrator.py:627-817``).

State is a plain dict pytree: ``{"x": position}`` for ODE/SDE families,
``{"x": position, "p": momentum}`` for symplectic ones.
"""

from __future__ import annotations

from typing import Any, Callable, ClassVar, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

Array = jax.Array
State = Dict[str, Array]
DriftFn = Callable[[Array, Array], Array]  # f(x, t) -> dx/dt

__all__ = [
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "BaseSymplecticIntegrator",
    "AdaptiveStats",
]


def _rms_norm(x: Array) -> Array:
    return jnp.sqrt(jnp.mean(jnp.square(x)))


@struct.dataclass
class AdaptiveStats:
    """On-device counters from an adaptive integration (scan outputs, no syncs)."""

    n_accepted: Array
    n_attempted: Array
    final_h: Array
    exhausted: Array  # True if max_steps hit before reaching t_end


class BaseIntegrator:
    """Common integrator contract.

    ``family`` tags the dynamics type ("ode" | "sde" | "symplectic") and is
    what :func:`torchebm_tpu.integrators.resolve_integrator` validates against
    (reference ``integrator_utils.py:55-111``).
    """

    family: str = "ode"

    def step(self, state: State, step_size, **kwargs) -> State:
        raise NotImplementedError

    def integrate(self, state: State, step_size, n_steps: int, **kwargs) -> State:
        raise NotImplementedError


@struct.dataclass
class BaseRungeKuttaIntegrator(BaseIntegrator):
    r"""Butcher-tableau Runge-Kutta base (reference ``base_integrator.py:98-624``).

    Subclasses define class attributes:

    - ``tableau_a``: tuple of tuples, row ``i`` holding :math:`a_{i0..}`
      (explicit rows have length ``i``; DIRK rows length ``i+1`` — a non-zero
      diagonal entry marks the stage implicit and triggers a Picard solve).
    - ``tableau_b`` / ``tableau_c``: weights and nodes.
    - ``error_weights`` (optional): :math:`e_i = b_i - \hat b_i` for the
      embedded pair (``n_stages + 1`` entries for FSAL methods).
    - ``order`` (optional): order ``p`` of the higher-order solution, used in
      the ``err^{-1/p}`` controller exponent.
    - ``fsal``: First-Same-As-Last stage reuse.
    """

    # --- adaptive controller configuration (reference ctor defaults) ---
    atol: float = struct.field(pytree_node=False, default=1e-6)
    rtol: float = struct.field(pytree_node=False, default=1e-5)
    max_steps: int = struct.field(pytree_node=False, default=10_000)
    safety: float = struct.field(pytree_node=False, default=0.9)
    min_factor: float = struct.field(pytree_node=False, default=0.2)
    max_factor: float = struct.field(pytree_node=False, default=10.0)
    max_step_size: float = struct.field(pytree_node=False, default=float("inf"))
    # --- implicit (DIRK) Picard solver configuration ---
    solver_max_iter: int = struct.field(pytree_node=False, default=8)
    solver_tol: float = struct.field(pytree_node=False, default=1e-6)
    solver_check_every: int = struct.field(pytree_node=False, default=0)

    # class-level tableau (overridden by concrete methods). ClassVar, NOT
    # dataclass fields: tuples-of-floats must stay static Python constants
    # baked into the trace, never pytree leaves.
    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ()
    tableau_b: ClassVar[Tuple[float, ...]] = ()
    tableau_c: ClassVar[Tuple[float, ...]] = ()
    error_weights: ClassVar[Optional[Tuple[float, ...]]] = None
    order: ClassVar[Optional[int]] = None
    fsal: ClassVar[bool] = False

    @property
    def n_stages(self) -> int:
        return len(self.tableau_c)

    # ------------------------------------------------------------------
    # stage evaluation
    # ------------------------------------------------------------------

    def _solve_implicit_stage(self, base: Array, t, h, a_ii: float, drift: DriftFn) -> Array:
        r"""Solve :math:`k = f(\text{base} + h a_{ii} k, t)` by Picard iteration.

        With ``solver_check_every <= 0`` (default): a fixed ``fori_loop`` of
        ``solver_max_iter`` total drift calls. Otherwise a ``while_loop``
        checks the RMS residual — on device, so unlike the reference
        (``base_integrator.py:377-384``) early exit costs nothing.
        """
        coef = h * a_ii
        k0 = drift(base, t)
        if self.solver_check_every <= 0:
            def body(_, k):
                return drift(base + coef * k, t)
            return jax.lax.fori_loop(0, self.solver_max_iter - 1, body, k0)

        def cond(carry):
            _, resid, it = carry
            return (it < self.solver_max_iter - 1) & (resid > self.solver_tol)

        def body(carry):
            k, _, it = carry
            k_next = drift(base + coef * k, t)
            return k_next, _rms_norm(k_next - k), it + 1

        # residual dtype must track the state dtype (f64 under enable_x64)
        k, _, _ = jax.lax.while_loop(
            cond, body, (k0, jnp.asarray(jnp.inf, k0.dtype), 0)
        )
        return k

    def _evaluate_stages(self, x: Array, t, h, drift: DriftFn, k0: Optional[Array] = None) -> list:
        """Evaluate all stages; returns a list of ``s`` arrays (unrolled in trace)."""
        a, c = self.tableau_a, self.tableau_c
        ks: list = []
        for i in range(self.n_stages):
            if i == 0 and k0 is not None:
                ks.append(k0)
                continue
            x_stage = x
            row = a[i] if i < len(a) else ()
            for j in range(min(i, len(row))):
                if row[j] != 0.0:
                    x_stage = x_stage + (h * row[j]) * ks[j]
            t_stage = t + c[i] * h
            if len(row) > i and row[i] != 0.0:  # DIRK diagonal entry
                ks.append(self._solve_implicit_stage(x_stage, t_stage, h, row[i], drift))
            else:
                ks.append(drift(x_stage, t_stage))
        return ks

    def _combine(self, x: Array, h, ks: list, weights: Tuple[float, ...]) -> Array:
        acc = None
        for w, k in zip(weights, ks):
            if w == 0.0:
                continue
            acc = (w * k) if acc is None else acc + w * k
        if acc is None:
            return x
        return x + h * acc

    def _deterministic_step(self, x: Array, h, drift: DriftFn, t) -> Array:
        ks = self._evaluate_stages(x, t, h, drift)
        return self._combine(x, h, ks, self.tableau_b)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def step(self, state: State, step_size, *, drift: DriftFn, t=None, **_) -> State:
        """One deterministic RK step of size ``step_size`` (always fixed-step)."""
        x = state["x"]
        t = jnp.asarray(0.0 if t is None else t, x.dtype)
        h = jnp.asarray(step_size, x.dtype)
        return {"x": self._deterministic_step(x, h, drift, t)}

    def _build_time_grid(self, x, step_size, n_steps: int, t):
        if t is None:
            if n_steps is None or n_steps <= 0:
                raise ValueError("n_steps must be positive")
            h = jnp.asarray(step_size, x.dtype)
            return jnp.arange(n_steps + 1, dtype=x.dtype) * h
        t = jnp.asarray(t, x.dtype)
        if t.ndim != 1 or t.shape[0] < 2:
            raise ValueError("t must be a 1D array with length >= 2")
        return t

    def integrate(
        self,
        state: State,
        step_size,
        n_steps: Optional[int] = None,
        *,
        drift: DriftFn,
        t: Optional[Array] = None,
        adaptive: Optional[bool] = None,
        return_stats: bool = False,
        **_,
    ) -> Union[State, Tuple[State, AdaptiveStats]]:
        """Integrate an ODE over a time grid.

        Fixed mode scans over the grid; adaptive mode (default when the method
        defines an embedded pair) runs the on-device step-size controller from
        ``t[0]`` to ``t[-1]``.
        """
        if adaptive is None:
            adaptive = self.error_weights is not None
        x = state["x"]
        if not adaptive:
            grid = self._build_time_grid(x, step_size, n_steps, t)
            ts, dts = grid[:-1], grid[1:] - grid[:-1]

            def body(xc, t_dt):
                ti, dti = t_dt
                return self._deterministic_step(xc, dti, drift, ti), None

            x_final, _ = jax.lax.scan(body, x, (ts, dts))
            return {"x": x_final}

        if self.error_weights is None or self.order is None:
            raise ValueError(
                f"{type(self).__name__} does not define error_weights/order "
                f"and cannot be used with adaptive=True."
            )
        if t is not None:
            t = jnp.asarray(t)
            t_start, t_end = t[0], t[-1]
        else:
            t_start = jnp.asarray(0.0)
            t_end = jnp.asarray(float(n_steps)) * jnp.asarray(step_size)
        x_final, stats = self._adaptive_integrate(
            x, drift, t_start, t_end, jnp.asarray(step_size)
        )
        out: State = {"x": x_final}
        if return_stats:
            return out, stats
        return out

    def _adaptive_integrate(self, x, drift: DriftFn, t_start, t_end, h0) -> Tuple[Array, AdaptiveStats]:
        r"""Embedded-pair adaptive loop, fully on device (reference ``:433-507``).

        Standard controller: accept iff ``err_ratio <= 1``; then
        ``h *= clamp(safety * err^{-1/p}, min_factor, max_factor)``, with FSAL
        first-stage reuse. The whole loop is one ``lax.while_loop`` — the
        accept/reject branch that forces a host sync per attempted step in the
        reference stays on the device here.
        """
        dtype = x.dtype
        p = float(self.order)
        is_fsal = self.fsal
        e = self.error_weights
        t_start = jnp.asarray(t_start, dtype)
        t_end = jnp.asarray(t_end, dtype)
        tiny = 1e-12 * jnp.maximum(jnp.abs(t_end), 1.0)

        h0 = jnp.minimum(jnp.minimum(jnp.asarray(h0, dtype), t_end - t_start), self.max_step_size)
        k1_0 = drift(x, t_start) if is_fsal else jnp.zeros_like(x)

        def cond(carry):
            _, t_cur, _, _, _, n_att = carry
            return (t_cur < t_end - tiny) & (n_att < self.max_steps)

        def body(carry):
            xc, t_cur, h, k1c, n_acc, n_att = carry
            h = jnp.minimum(jnp.minimum(h, t_end - t_cur), self.max_step_size)
            ks = self._evaluate_stages(xc, t_cur, h, drift, k0=k1c if is_fsal else None)
            y_new = self._combine(xc, h, ks, self.tableau_b)
            if is_fsal:
                # NOTE: tableaus here store only the s "real" stages (dopri5:
                # 6), so this extra eval at the accepted point is NOT
                # redundant — it is the (s+1)-th error stage AND the next
                # step's first stage. Per accepted step the drift costs s
                # evals, the FSAL minimum.
                k_fsal = drift(y_new, t_cur + h)
                ks_err = ks + [k_fsal]
            else:
                k_fsal = k1c
                ks_err = ks
            err_vec = self._combine(jnp.zeros_like(xc), h, ks_err, e)
            scale = self.atol + self.rtol * jnp.maximum(jnp.abs(xc), jnp.abs(y_new))
            err_ratio = _rms_norm(err_vec / scale)

            accept = err_ratio <= 1.0
            xc = jnp.where(accept, y_new, xc)
            t_cur = jnp.where(accept, t_cur + h, t_cur)
            if is_fsal:
                k1c = jnp.where(accept, k_fsal, k1c)
            factor = jnp.where(
                err_ratio == 0.0,
                self.max_factor,
                jnp.clip(
                    self.safety * jnp.power(jnp.maximum(err_ratio, 1e-30), -1.0 / p),
                    self.min_factor,
                    self.max_factor,
                ),
            )
            h = jnp.minimum(h * factor, self.max_step_size)
            return xc, t_cur, h, k1c, n_acc + accept.astype(jnp.int32), n_att + 1

        x_f, t_f, h_f, _, n_acc, n_att = jax.lax.while_loop(
            cond, body, (x, t_start, h0, k1_0, jnp.int32(0), jnp.int32(0))
        )
        stats = AdaptiveStats(
            n_accepted=n_acc,
            n_attempted=n_att,
            final_h=h_f,
            exhausted=(t_f < t_end - tiny),
        )
        return x_f, stats


@struct.dataclass
class BaseSDERungeKuttaIntegrator(BaseRungeKuttaIntegrator):
    r"""RK deterministic update + Euler-order additive noise (reference ``:627-817``).

    Solves :math:`dx = f(x,t)\,dt + \sqrt{2 D}\,dW_t` as

    .. math:: x_{n+1} = \Big(x_n + h \sum_i b_i k_i\Big) + \sqrt{2 D h}\,\varepsilon

    (strong order 0.5 for multiplicative noise, exact order for additive).
    ``diffusion`` may be a scalar/array :math:`D`; when omitted it defaults to
    ``noise_scale**2`` — so Langevin's ``noise_scale`` multiplies
    :math:`\sqrt{2h}` exactly as in the reference.
    """

    family: ClassVar[str] = "sde"

    def step(
        self,
        state: State,
        step_size,
        *,
        drift: DriftFn,
        key: Optional[Array] = None,
        noise_scale=1.0,
        diffusion=None,
        t=None,
        noise: Optional[Array] = None,
        **_,
    ) -> State:
        x = state["x"]
        t = jnp.asarray(0.0 if t is None else t, x.dtype)
        h = jnp.asarray(step_size, x.dtype)
        x_det = self._deterministic_step(x, h, drift, t)
        if noise is None:
            if key is None:
                raise ValueError("SDE step requires a PRNG `key` (or explicit `noise`).")
            noise = jax.random.normal(key, x.shape, x.dtype)
        if diffusion is None:
            amp = jnp.asarray(noise_scale, x.dtype) * jnp.sqrt(2.0 * h)
        else:
            amp = jnp.sqrt(2.0 * jnp.asarray(diffusion, x.dtype) * h)
        return {"x": x_det + amp * noise}

    def integrate(
        self,
        state: State,
        step_size,
        n_steps: Optional[int] = None,
        *,
        drift: DriftFn,
        key: Optional[Array] = None,
        noise_scale=1.0,
        diffusion=None,
        t: Optional[Array] = None,
        **_,
    ) -> State:
        """Fixed-grid SDE integration as one ``lax.scan`` with per-step key folding."""
        x = state["x"]
        if key is None:
            raise ValueError("SDE integrate requires a PRNG `key`.")
        grid = self._build_time_grid(x, step_size, n_steps, t)
        ts, dts = grid[:-1], grid[1:] - grid[:-1]
        n = ts.shape[0]
        keys = jax.random.split(key, n)

        def body(xc, inp):
            ti, dti, ki = inp
            out = self.step(
                {"x": xc}, dti, drift=drift, key=ki,
                noise_scale=noise_scale, diffusion=diffusion, t=ti,
            )
            return out["x"], None

        x_final, _ = jax.lax.scan(body, x, (ts, dts, keys))
        return {"x": x_final}


@struct.dataclass
class BaseSymplecticIntegrator(BaseIntegrator):
    """Symplectic family base (reference ``base_integrator.py:820-889``).

    ``separable`` subclasses take ``drift(x, t)`` (= force) + ``mass``;
    non-separable ones take ``force(x, p, t)`` + ``velocity(x, p, t)``.
    ``safe`` mode clamps forces to ±1e6 and sanitizes NaN/Inf — branch-free on
    the device, matching the reference's sync-free rationale.
    """

    family: ClassVar[str] = "symplectic"
    separable: ClassVar[bool] = True

    SAFE_CLAMP: ClassVar[float] = 1e6

    @staticmethod
    def _safe_clamp(v: Array) -> Array:
        v = jnp.clip(v, -BaseSymplecticIntegrator.SAFE_CLAMP, BaseSymplecticIntegrator.SAFE_CLAMP)
        return jnp.nan_to_num(v, nan=0.0, posinf=BaseSymplecticIntegrator.SAFE_CLAMP,
                              neginf=-BaseSymplecticIntegrator.SAFE_CLAMP)

    @staticmethod
    def _broadcast_mass(mass, x: Array):
        """Reshape a per-dimension mass vector for broadcasting against ``x``."""
        mass = jnp.asarray(mass, x.dtype)
        if mass.ndim == 0:
            return jnp.maximum(mass, 1e-10)
        shape = (1,) * (x.ndim - 1) + (-1,)
        return jnp.maximum(mass.reshape(shape), 1e-10)
