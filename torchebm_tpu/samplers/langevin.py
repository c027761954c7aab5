r"""Langevin dynamics sampler.

Reference: ``torchebm/samplers/langevin_dynamics.py:16-188``. Update rule

.. math::
    x_{t+1} = x_t - \eta\, \nabla_x U(x_t)
    + \text{noise\_scale}\cdot\sqrt{2\eta}\,\varepsilon_t

via a pluggable SDE integrator (default Euler–Maruyama). ``step_size`` and
``noise_scale`` are schedulable; optional ``clamp`` bounds the state per step
(image-EBM stabilization). The whole chain compiles to one XLA program through
:class:`~torchebm_tpu.samplers.base.BaseSampler`; on a GPU, eager calls on
the analytic energies the whole-chain kernel knows
(:mod:`torchebm_tpu.ops.fused_langevin`) run as one kernel launch instead.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import (
    DoubleWellEnergy,
    Energy,
    GaussianEnergy,
    GaussianMixtureEnergy,
)
from ..core.schedulers import BaseScheduler, sched_value
from ..ops.fused_langevin import MAX_DIM, MAX_K_TIMES_D
from ..integrators import (
    BaseSDERungeKuttaIntegrator,
    EulerMaruyamaIntegrator,
    resolve_integrator,
)
from ..ops import FUSED_MODES, kernels_enabled
from .base import BaseSampler, _concrete_scalar, _upgrade_key

Array = jax.Array

__all__ = ["LangevinDynamics"]


@partial(jax.jit, static_argnames=("n_steps", "block"))
def _block_noise_impl(sampler, x0, key, n_steps, block, model_kwargs):
    r"""Euler–Maruyama Langevin chain with block noise generation.

    Draws the Gaussian noise for ``block`` steps in ONE ``jax.random.normal``
    call per outer iteration and unrolls the inner updates — fewer
    random-bit launches and loop iterations per step. Semantics are identical to the generic path (schedulers at the absolute
    step index, clamp, step-aware energies); only the PRNG *stream* differs
    (one draw of shape ``(block, ...)`` instead of ``block`` draws).
    """
    n_outer = n_steps // block
    remainder = n_steps - n_outer * block

    def one_step(x, i, eps):
        h = sched_value(sampler.step_size, i)
        ns = sched_value(sampler.noise_scale, i)
        g = sampler.gradient_of(x, model_kwargs, step=i)
        new = x - h * g + ns * jnp.sqrt(2.0 * h) * eps
        if sampler.clamp is not None:
            new = jnp.clip(new, sampler.clamp[0], sampler.clamp[1])
        # preserve the caller's state dtype (f32 scheduler scalars / model
        # params must not promote a bf16 chain out of the scan carry)
        return new.astype(x.dtype)

    def outer(x, j):
        eps = jax.random.normal(jax.random.fold_in(key, j), (block, *x.shape), x.dtype)
        base = j * block

        def inner(u, xx):
            return one_step(xx, base + u, eps[u])

        return jax.lax.fori_loop(0, block, inner, x, unroll=block), None

    x, _ = jax.lax.scan(outer, x0, jnp.arange(n_outer))
    for r in range(remainder):  # < block trailing steps, distinct key folds
        i = n_outer * block + r
        eps = jax.random.normal(jax.random.fold_in(key, n_outer + 1 + r), x.shape, x.dtype)
        x = one_step(x, i, eps)
    return x


def _sched_concrete(p) -> bool:
    """True if a schedulable parameter is a constant (Python number or
    concrete 0-d array — e.g. a warmup-adapted device scalar) or a scheduler
    whose per-step table is concrete at dispatch time (no traced leaves)."""
    if _concrete_scalar(p):
        return True
    if isinstance(p, BaseScheduler):
        return not any(
            isinstance(leaf, jax.core.Tracer)
            for leaf in jax.tree_util.tree_leaves(p)
        )
    return False


def _sched_table_arg(p, n_steps: int):
    """Chain-kernel argument form of a schedulable parameter: a Python float
    (constant) or the concrete ``(n_steps,)`` per-step value table."""
    if _concrete_scalar(p):
        return float(p)
    return jax.vmap(p.value)(jnp.arange(n_steps))


# --------------------------------------------------------------------------
# fused-dispatch table: ordered (predicate -> whole-chain kernel entry) rows.
# Adding a kernel target = adding one row here; the dispatch-matrix tests
# (tests/samplers/test_langevin.py::TestFusedDispatch) exercise every row.
# --------------------------------------------------------------------------


class _FusedRow(NamedTuple):
    """One fused-dispatch rule.

    ``model_type``: exact model class the row handles (identity-matched — a
    subclass may override ``energy`` and must not inherit the kernel).
    ``supports(sampler)``: target-parameter gate (concreteness, the kernel's
    size caps) — evaluated by ``_fusable`` before any state exists.
    ``kernel_kwargs(sampler, x0)``: state-shape gate + the target-specific
    kernel arguments, or None to fall back to the scan path.
    ``chain``/``trajectory``: attribute names in ``ops.fused_langevin``
    (resolved at call time so tests can monkeypatch the module).
    """

    name: str
    model_type: type
    supports: Callable[["LangevinDynamics"], bool]
    kernel_kwargs: Callable[["LangevinDynamics", Array], Optional[dict]]
    chain: str
    trajectory: str


def _isotropic_scale(model) -> Optional[float]:
    """σ if ``model`` is a concrete isotropic Gaussian (cov = σ²I), else None.

    Shared by the Langevin and gradient-descent kernel dispatches."""
    import numpy as np

    if isinstance(model.cov, jax.core.Tracer) or isinstance(
        model.mean, jax.core.Tracer
    ):
        return None
    cov = np.asarray(model.cov)
    var = float(cov[0, 0])
    if var <= 0 or not np.allclose(cov, var * np.eye(cov.shape[0]), atol=1e-12):
        return None
    return float(np.sqrt(var))


def _dw_supports(s: "LangevinDynamics") -> bool:
    return isinstance(s.model.barrier_height, (int, float)) and isinstance(
        s.model.b, (int, float)
    )


def _dw_kwargs(s: "LangevinDynamics", x0: Array) -> Optional[dict]:
    if x0.ndim != 2 or x0.shape[-1] > MAX_DIM:
        return None
    return dict(barrier_height=float(s.model.barrier_height), b=float(s.model.b))


def _gaussian_supports(s: "LangevinDynamics") -> bool:
    """Isotropic Gaussians only (a one-component mixture); full covariances
    run on the scan."""
    iso = s._isotropic_gaussian_scale()
    return iso is not None and s.model.mean.ndim == 1 and s.model.mean.shape[-1] <= MAX_DIM


def _gaussian_kwargs(s: "LangevinDynamics", x0: Array) -> Optional[dict]:
    m = s.model
    if x0.ndim != 2 or x0.shape[-1] != m.mean.shape[-1]:
        return None
    return dict(means=m.mean[None, :], scale=s._isotropic_gaussian_scale())


def _mixture_supports(s: "LangevinDynamics") -> bool:
    m = s.model
    if isinstance(m.means, jax.core.Tracer) or isinstance(m.scale, jax.core.Tracer):
        return False
    k, d = m.means.shape
    return d <= MAX_DIM and k * d <= MAX_K_TIMES_D


def _mixture_kwargs(s: "LangevinDynamics", x0: Array) -> Optional[dict]:
    m = s.model
    if x0.ndim != 2 or x0.shape[-1] != m.means.shape[-1]:
        return None
    return dict(means=m.means, scale=float(m.scale), log_weights=m.log_weights)


def _fused_gates_ok(sampler, key, x, model_kwargs, *, schedulables,
                    integrator=None) -> bool:
    """The generic fused-dispatch gates shared by Langevin / GD: kernels
    enabled on this backend (:func:`~torchebm_tpu.ops.kernels_enabled`),
    eager single-program calls, no conditioning, and concrete schedulable
    parameters (plus the default-EM integrator where one exists), with a
    state that lives on one device."""
    if not kernels_enabled(sampler.fused):
        return False
    if model_kwargs:
        return False
    if isinstance(key, jax.core.Tracer) or isinstance(x, jax.core.Tracer):
        return False
    if isinstance(x, jax.Array) and len(x.sharding.device_set) > 1:
        return False  # a mesh-sharded state: the kernel has no partitioning rule
    if integrator is not None and type(integrator) is not EulerMaruyamaIntegrator:
        return False
    return all(_sched_concrete(p) for p in schedulables)


def _call_fused_row(
    row,
    x0,
    model,
    *,
    n_steps,
    thin,
    return_trajectory,
    return_diagnostics,
    kargs,
    step_size,
    noise_scale,
    seed,
    clamp,
):
    """Invoke a dispatch row's chain/trajectory kernel and package outputs.

    Shared by :class:`LangevinDynamics` and the zero-noise
    :class:`~torchebm_tpu.samplers.gradient_descent.GradientDescentSampler`
    dispatch (GD is exactly the Langevin kernel at ``noise_scale = 0``)."""
    from ..ops import fused_langevin as ops

    common = dict(
        n_steps=int(n_steps),
        step_size=step_size,
        noise_scale=noise_scale,
        seed=seed,
        clamp=clamp,
    )
    if return_trajectory or return_diagnostics:
        traj, final = getattr(ops, row.trajectory)(x0, thin=int(thin), **kargs, **common)
        out = jnp.moveaxis(traj, 0, 1) if return_trajectory else final
        if not return_diagnostics:
            return out
        mean = jnp.mean(traj, axis=1)
        var = jnp.clip(jnp.var(traj, axis=1), 1e-10, 1e10)
        energy = jax.vmap(lambda xx: jnp.mean(model.energy(xx)))(traj)
        return out, {"mean": mean, "var": var, "energy": energy}
    return getattr(ops, row.chain)(x0, **kargs, **common)


#: ordered dispatch rows; first row whose ``model_type`` + ``supports`` match
#: wins (the order only matters if two rows ever claim the same model type).
FUSED_DISPATCH: Tuple[_FusedRow, ...] = (
    _FusedRow(
        "doublewell",
        DoubleWellEnergy,
        _dw_supports,
        _dw_kwargs,
        "doublewell_langevin_chain",
        "doublewell_langevin_chain_trajectory",
    ),
    _FusedRow(
        "gaussian",
        GaussianEnergy,
        _gaussian_supports,
        _gaussian_kwargs,
        "mixture_langevin_chain",
        "mixture_langevin_chain_trajectory",
    ),
    _FusedRow(
        "mixture",
        GaussianMixtureEnergy,
        _mixture_supports,
        _mixture_kwargs,
        "mixture_langevin_chain",
        "mixture_langevin_chain_trajectory",
    ),
)


@struct.dataclass
class LangevinDynamics(BaseSampler):
    """Overdamped Langevin MCMC over a pluggable SDE integrator."""

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    noise_scale: Union[float, BaseScheduler] = 1.0
    clamp: Optional[Tuple[float, float]] = struct.field(pytree_node=False, default=None)
    integrator: BaseSDERungeKuttaIntegrator = None
    fused: str = struct.field(pytree_node=False, default="auto")
    #: transition-loop unroll factor (see BaseSampler docstring); >1 pays off
    #: for cheap analytic energies, not for neural ones.
    unroll: int = struct.field(pytree_node=False, default=1)
    #: chain PRNG implementation: "auto" (see ``base._upgrade_key``),
    #: "threefry", "rbg" or "unsafe_rbg".
    rng_impl: str = struct.field(pytree_node=False, default="auto")
    #: >1 draws Gaussian noise for this many steps per PRNG call and unrolls
    #: the updates (default-EM path, thin=1, no trajectory/diagnostics only;
    #: falls back otherwise). Same distribution and scheduler semantics as
    #: the generic path but a different — equally valid — noise stream.
    noise_block: int = struct.field(pytree_node=False, default=1)

    def __post_init__(self):
        if self.clamp is not None and self.clamp[0] >= self.clamp[1]:
            raise ValueError(f"clamp min must be < max, got {self.clamp}")
        if self.noise_block < 1:
            raise ValueError("noise_block must be >= 1")
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {self.fused!r}")
        integ = resolve_integrator(
            self.integrator, default="euler_maruyama", families=("sde",)
        )
        object.__setattr__(self, "integrator", integ)

    def step(self, carry, i, key, model_kwargs):
        x = carry["x"]
        out = self.integrator.step(
            {"x": x},
            sched_value(self.step_size, i),
            drift=lambda x_, t_: -self.gradient_of(x_, model_kwargs, step=i),
            key=key,
            noise_scale=sched_value(self.noise_scale, i),
        )
        x = out["x"]
        if self.clamp is not None:
            x = jnp.clip(x, self.clamp[0], self.clamp[1])
        return {"x": x}

    # -------------------------------------------------------- fused fast path

    def _fused_row(self) -> Optional[_FusedRow]:
        """The :data:`FUSED_DISPATCH` row claiming this sampler's model, if any."""
        for row in FUSED_DISPATCH:
            if type(self.model) is row.model_type and row.supports(self):
                return row
        return None

    def _dispatch_row(
        self, key, x, model_kwargs
    ) -> Optional[_FusedRow]:
        """Generic fused gates + row lookup in ONE pass (None = scan path).

        ``fused="force"`` raises where the call cannot run as one kernel."""
        row = None
        if _fused_gates_ok(
            self, key, x, model_kwargs,
            schedulables=(self.step_size, self.noise_scale),
            integrator=self.integrator,
        ):
            row = self._fused_row()
        if row is None and self.fused == "force":
            raise ValueError(
                "fused='force': this call cannot run as one kernel (it needs an "
                "eager call, no model_kwargs, the default Euler-Maruyama "
                "integrator, concrete schedules, and a DoubleWellEnergy, an "
                "isotropic GaussianEnergy or a GaussianMixtureEnergy with "
                f"d <= {MAX_DIM} and K*d <= {MAX_K_TIMES_D})"
            )
        return row

    def _fusable(self, key, x, return_trajectory, return_diagnostics, model_kwargs) -> bool:
        """Whether this exact call maps onto the whole-chain kernel.

        The dispatch is conservative: GPU backend, eager single-program calls
        only (inside a user ``jit``/``shard_map`` the generic scan path is
        used — it shards and traces transparently), default Euler–Maruyama,
        constant OR scheduled step/noise (any :class:`BaseScheduler` with a
        concrete table — e.g. the Energy-Matching
        :class:`TemperatureScheduler`), thinned trajectories AND diagnostics
        (kept states stored in-kernel; mean/var/energy then computed from the
        kernel trajectory), no conditioning, and an analytic energy one of
        the :data:`FUSED_DISPATCH` rows claims (:class:`DoubleWellEnergy`,
        isotropic :class:`GaussianEnergy`, and :class:`GaussianMixtureEnergy`,
        with d ≤ 64 and K·d ≤ 1024). ``clamp`` is folded into the kernel.
        ``fused="off"`` disables; ``"force"`` raises instead of falling back.
        """
        return self._dispatch_row(key, x, model_kwargs) is not None

    # NOTE: kept as the documented boolean API; sample() uses _dispatch_row
    # so the (host-side) row predicates run once per call, not twice.

    def _isotropic_gaussian_scale(self):
        """σ if ``model`` is a concrete isotropic Gaussian (cov = σ²I), else None."""
        return _isotropic_scale(self.model)

    def sample(
        self,
        key: Array,
        x: Optional[Array] = None,
        dim=None,
        n_steps: int = 100,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs=None,
    ):
        """Run the chain; eager GPU calls on supported analytic energies are
        dispatched to the whole-chain kernel in
        :mod:`torchebm_tpu.ops.fused_langevin` (the state stays in registers
        for all steps), everything else to the shared compiled scan."""
        row = self._dispatch_row(key, x, model_kwargs)
        if row is not None:
            key_init, key_run = jax.random.split(key)
            x0 = self._init_state(key_init, x, dim, n_samples)
            kargs = row.kernel_kwargs(self, x0)
            if kargs is not None and (
                not (return_trajectory or return_diagnostics) or n_steps // thin >= 1
            ):
                seed = jax.random.randint(key_run, (), 0, jnp.iinfo(jnp.int32).max)
                return _call_fused_row(
                    row,
                    x0,
                    self.model,
                    n_steps=n_steps,
                    thin=thin,
                    return_trajectory=return_trajectory,
                    return_diagnostics=return_diagnostics,
                    kargs=kargs,
                    step_size=_sched_table_arg(self.step_size, n_steps),
                    noise_scale=_sched_table_arg(self.noise_scale, n_steps),
                    seed=seed,
                    clamp=self.clamp,
                )
            if self.fused == "force":
                raise ValueError(
                    "fused='force': the state must be (n_chains, d) matching the "
                    "target, and n_steps // thin >= 1 for trajectories"
                )
            # unsupported state shape / n_steps < thin: fall through to the scan
        if (
            self.noise_block > 1
            and thin == 1
            and not return_trajectory
            and not return_diagnostics
            and type(self.integrator) is EulerMaruyamaIntegrator
            and n_steps >= self.noise_block
        ):
            key = _upgrade_key(key, self.rng_impl)
            key_init, key_run = jax.random.split(key)
            x0 = self._init_state(key_init, x, dim, n_samples)
            return _block_noise_impl(
                self, x0, key_run, n_steps, self.noise_block, model_kwargs or {}
            )
        return super().sample(
            key,
            x=x,
            dim=dim,
            n_steps=n_steps,
            n_samples=n_samples,
            thin=thin,
            return_trajectory=return_trajectory,
            return_diagnostics=return_diagnostics,
            model_kwargs=model_kwargs,
        )
