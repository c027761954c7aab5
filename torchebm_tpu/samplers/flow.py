r"""Flow-based sampler for trained generative models (ODE / SDE generation).

Reference: ``torchebm/samplers/flow.py:67-625``. The sampler is configured at
construction along the taxonomy axes: mode (probability-flow ODE vs reverse
diffusion SDE), interpolant, prediction type (velocity/score/noise),
EqM ``negate_velocity``, ODE ``reverse`` (via the :math:`s = t - t_0` change of
variables), and the SDE diffusion form / last-step correction.

Differences in this JAX design:

- Fixed-step generation compiles to one ``lax.scan``; the adaptive path uses
  the on-device ``while_loop`` controller from the integrator layer — the
  reference's per-attempt ``.item()`` sync (``base_integrator.py:481-483``)
  does not exist here.
- ``model`` is any callable ``model(x, t, **kwargs)`` with ``t`` of shape
  ``(batch,)``; use :class:`WrappedField` to adapt a flax ``apply``/params
  pair so parameter updates don't retrigger compilation.
- ``train_eps``/``sample_eps`` accept floats or schedulers; they are evaluated
  at call entry (static for the trace), which is where the reference's
  per-call scheduler advancement lands in a stateless design.
"""

from __future__ import annotations

import enum
import math
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.schedulers import BaseScheduler, sched_init
from ..integrators import (
    BaseRungeKuttaIntegrator,
    BaseSDERungeKuttaIntegrator,
    resolve_integrator,
)
from ..interpolants import (
    BaseInterpolant,
    CosineInterpolant,
    LinearInterpolant,
    VariancePreservingInterpolant,
    expand_t_like_x,
    resolve_interpolant,
)
from .base import BaseSampler

Array = jax.Array

__all__ = ["FlowSampler", "PredictionType", "WrappedField"]

_LAST_STEPS = ("Mean", "Euler", "Tweedie", None)


class PredictionType(enum.Enum):
    """Model prediction type (reference ``flow.py:59-65``)."""

    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


_PREDICTION_MAP = {
    "velocity": PredictionType.VELOCITY,
    "score": PredictionType.SCORE,
    "noise": PredictionType.NOISE,
}


@struct.dataclass
class WrappedField:
    """Adapts ``fn(params, x, t, **kw)`` into the ``model(x, t, **kw)`` contract.

    ``fn`` is static; ``params`` is a pytree leaf container (train without
    recompiles). The standard way to hand a flax module to
    :class:`FlowSampler`: ``WrappedField(model.apply, params)``.
    """

    fn: Callable[..., Array] = struct.field(pytree_node=False)
    params: Any = None

    def __call__(self, x: Array, t: Array, **kwargs: Any) -> Array:
        if self.params is None:
            return self.fn(x, t, **kwargs)
        return self.fn(self.params, x, t, **kwargs)


@struct.dataclass
class FlowSampler(BaseSampler):
    """ODE/SDE sampler for trained velocity/score/noise fields."""

    model: Any = None
    mode: str = struct.field(pytree_node=False, default="ode")
    interpolant: BaseInterpolant = "linear"
    prediction: str = struct.field(pytree_node=False, default="velocity")
    train_eps: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=0.0)
    sample_eps: Union[float, BaseScheduler] = struct.field(pytree_node=False, default=0.0)
    negate_velocity: bool = struct.field(pytree_node=False, default=False)
    reverse: bool = struct.field(pytree_node=False, default=False)
    diffusion_form: Optional[str] = struct.field(pytree_node=False, default=None)
    diffusion_norm: Optional[float] = struct.field(pytree_node=False, default=None)
    last_step: Any = struct.field(pytree_node=False, default="__unset__")
    last_step_size: Optional[float] = struct.field(pytree_node=False, default=None)
    integrator: BaseRungeKuttaIntegrator = None

    def __post_init__(self):
        if self.mode not in ("ode", "sde"):
            raise ValueError(f"Unknown mode: {self.mode!r}. Choose from ['ode', 'sde']")
        if self.prediction not in _PREDICTION_MAP:
            raise ValueError(
                f"Unknown prediction: {self.prediction!r}. Choose from {list(_PREDICTION_MAP)}"
            )
        object.__setattr__(
            self, "interpolant", resolve_interpolant(self.interpolant, default="linear")
        )
        # Bare callables (lambdas, functions) are not valid pytree leaves under
        # jit; wrap them so the function is static and any params stay leaves.
        if callable(self.model) and not hasattr(self.model, "__dataclass_fields__"):
            object.__setattr__(self, "model", WrappedField(fn=self.model))

        if self.mode == "ode":
            offenders = [
                name
                for name, value in (
                    ("diffusion_form", self.diffusion_form),
                    ("diffusion_norm", self.diffusion_norm),
                    ("last_step_size", self.last_step_size),
                )
                if value is not None
            ]
            # Note: None is also accepted as "unset" — __post_init__ re-runs on
            # pytree unflatten inside jit, after last_step was normalized.
            if self.last_step not in ("__unset__", None):
                offenders.append("last_step")
            if offenders:
                raise ValueError(f"{', '.join(sorted(offenders))} only apply to mode='sde'")
            object.__setattr__(self, "last_step", None)
            object.__setattr__(self, "last_step_size", None)
        else:
            if self.reverse:
                raise ValueError("reverse=True is not supported for mode='sde'")
            object.__setattr__(
                self,
                "diffusion_form",
                self.diffusion_form if self.diffusion_form is not None else "SBDM",
            )
            object.__setattr__(
                self,
                "diffusion_norm",
                self.diffusion_norm if self.diffusion_norm is not None else 1.0,
            )
            ls = "Mean" if self.last_step == "__unset__" else self.last_step
            if ls not in _LAST_STEPS:
                raise ValueError(f"Unknown last_step: {ls!r}. Choose from {list(_LAST_STEPS)}")
            object.__setattr__(self, "last_step", ls)
            lss = self.last_step_size if self.last_step_size is not None else 0.04
            object.__setattr__(self, "last_step_size", 0.0 if ls is None else lss)

        families = ("ode", "sde") if self.mode == "ode" else ("sde",)
        integ = resolve_integrator(
            self.integrator,
            default="dopri5" if self.mode == "ode" else "euler_maruyama",
            families=families,
        )
        if self.mode == "sde" and integ.error_weights is not None:
            raise ValueError(
                "Adaptive integrators are ODE-only; mode='sde' requires a "
                f"fixed-step integrator, got {type(integ).__name__}"
            )
        object.__setattr__(self, "integrator", integ)

    # ---------------------------------------------------------------- pieces

    @property
    def prediction_type(self) -> PredictionType:
        return _PREDICTION_MAP[self.prediction]

    @property
    def default_n_steps(self) -> int:
        return 50 if self.mode == "ode" else 250

    def _call_model(self, x: Array, t: Array, model_kwargs) -> Array:
        t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
        return self.model(x, t_b, **(model_kwargs or {}))

    def _get_drift(self, model_kwargs) -> Callable[[Array, Array], Array]:
        """Probability-flow drift per prediction type (reference ``flow.py:241-266``)."""
        ptype = self.prediction_type

        if ptype is PredictionType.VELOCITY:

            def drift(x, t):
                v = self._call_model(x, t, model_kwargs)
                return -v if self.negate_velocity else v

        elif ptype is PredictionType.SCORE:

            def drift(x, t):
                t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
                drift_mean, drift_var = self.interpolant.compute_drift(x, t_b)
                return -drift_mean + drift_var * self._call_model(x, t, model_kwargs)

        else:

            def drift(x, t):
                t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
                drift_mean, drift_var = self.interpolant.compute_drift(x, t_b)
                sigma_t, _ = self.interpolant.compute_sigma_t(expand_t_like_x(t_b, x))
                score = self._call_model(x, t, model_kwargs) / (-sigma_t + 1e-8)
                return -drift_mean + drift_var * score

        return drift

    def _get_score(self, model_kwargs) -> Callable[[Array, Array], Array]:
        ptype = self.prediction_type

        if ptype is PredictionType.VELOCITY:

            def score(x, t):
                t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
                return self.interpolant.velocity_to_score(
                    self._call_model(x, t, model_kwargs), x, t_b
                )

        elif ptype is PredictionType.SCORE:

            def score(x, t):
                return self._call_model(x, t, model_kwargs)

        else:

            def score(x, t):
                t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
                sigma_t, _ = self.interpolant.compute_sigma_t(expand_t_like_x(t_b, x))
                return self._call_model(x, t, model_kwargs) / (-sigma_t + 1e-8)

        return score

    def _check_interval(self) -> Tuple[float, float]:
        """Forward interval ``(t0, t1)`` (reference ``flow.py:290-316``)."""
        t0, t1 = 0.0, 1.0
        eps = sched_init(self.sample_eps)
        sde = self.mode == "sde"
        last_step_size = self.last_step_size if sde else 0.0

        is_vp = isinstance(self.interpolant, VariancePreservingInterpolant)
        is_lin_cos = isinstance(self.interpolant, (LinearInterpolant, CosineInterpolant))
        velocity = self.prediction_type is PredictionType.VELOCITY

        if is_vp:
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif is_lin_cos and (not velocity or sde):
            t0 = (
                eps
                if (self.diffusion_form == "SBDM" and sde) or not velocity
                else 0.0
            )
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        return t0, t1

    def _sde_dynamics(self, model_kwargs):
        """Reverse-SDE drift and diffusion (reference ``flow.py:343-363``)."""
        drift_fn = self._get_drift(model_kwargs)
        score_fn = self._get_score(model_kwargs)

        def diffusion_fn(x, t):
            t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
            return self.interpolant.compute_diffusion(
                x, t_b, form=self.diffusion_form, norm=self.diffusion_norm
            )

        def sde_drift(x, t):
            return drift_fn(x, t) + diffusion_fn(x, t) * score_fn(x, t)

        return sde_drift, diffusion_fn

    def _apply_last_step(self, x, t, sde_drift, model_kwargs):
        """Final SDE denoising correction (reference ``flow.py:589-609``)."""
        ls = self.last_step
        if ls == "Mean":
            return x + sde_drift(x, t) * self.last_step_size
        if ls == "Euler":
            return x + self._get_drift(model_kwargs)(x, t) * self.last_step_size
        if ls == "Tweedie":
            t_b = jnp.broadcast_to(jnp.asarray(t, x.dtype), (x.shape[0],))
            te = expand_t_like_x(t_b, x)
            alpha, _ = self.interpolant.compute_alpha_t(te)
            sigma, _ = self.interpolant.compute_sigma_t(te)
            score = self._get_score(model_kwargs)(x, t)
            return x / alpha + jnp.square(sigma) / alpha * score
        return x

    def prior_logp(self, z: Array) -> Array:
        """Standard-normal prior log-density (reference ``flow.py:616-622``)."""
        n = math.prod(z.shape[1:])
        return -n / 2.0 * math.log(2 * math.pi) - jnp.sum(
            jnp.square(z).reshape(z.shape[0], -1), axis=-1
        ) / 2.0

    def log_prob(
        self,
        x: Array,
        *,
        key: Optional[Array] = None,
        n_steps: int = 100,
        hutchinson: Optional[bool] = None,
        n_probes: int = 1,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Array:
        r"""Exact model log-likelihood via the probability-flow ODE.

        Build addition beyond the reference (which only ships ``prior_logp``):
        the instantaneous change of variables (Chen et al. 2018, "Neural
        ODEs") integrated backwards from data ``x`` at :math:`t_1` to the
        prior at :math:`t_0` with an RK4 scan,

        .. math::
            \log p_{t_1}(x) = \log p_{t_0}(x_{t_0})
            - \int_{t_0}^{t_1} \nabla\!\cdot u(x_t, t)\,dt .

        The divergence is the exact Jacobian trace (``hutchinson=False``;
        default when the event has ≤ 8 elements, costing d forward-mode
        passes per stage) or the unbiased Hutchinson–Rademacher estimator via
        ``jvp`` (``hutchinson=True``; requires ``key``; ``n_probes`` probes,
        fixed along the trajectory). ODE mode with ``reverse=False`` only.
        """
        if self.mode != "ode":
            raise ValueError("log_prob requires mode='ode' (probability-flow ODE)")
        if self.reverse:
            raise ValueError("log_prob is defined for reverse=False flows")
        d = math.prod(x.shape[1:])
        if hutchinson is None:
            hutchinson = d > 8
        if hutchinson and key is None:
            raise ValueError("hutchinson divergence estimation requires key=")
        if key is None:
            key = jax.random.PRNGKey(0)  # unused by the exact path
        return _flow_logprob_impl(
            self, x, key, int(n_steps), bool(hutchinson), int(n_probes),
            model_kwargs or {},
        )

    # ---------------------------------------------------------------- sample

    def sample(
        self,
        key: Array,
        x: Optional[Array] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_steps: Optional[int] = None,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Integrate the configured ODE/SDE. See reference ``flow.py:365-562``.

        Adaptive integrators (``dopri5``/``dopri8``/...) return only the final
        state; ``thin``/``return_trajectory`` require a fixed-step integrator.
        """
        if thin < 1:
            raise ValueError("thin must be >= 1")
        if n_steps is None:
            n_steps = self.default_n_steps
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        adaptive = self.integrator.error_weights is not None
        if adaptive and (return_trajectory or thin != 1):
            raise NotImplementedError(
                "return_trajectory/thin require a fixed-step integrator; "
                f"adaptive {type(self.integrator).__name__} returns only the "
                "final state. Construct FlowSampler(integrator='euler') or "
                "another fixed-step method."
            )
        key_init, key_run = jax.random.split(key)
        x0 = self._init_state(key_init, x, dim, n_samples)
        return _flow_sample_impl(
            self,
            x0,
            key_run,
            n_steps,
            thin,
            bool(return_trajectory),
            bool(return_diagnostics),
            model_kwargs or {},
        )


@partial(
    jax.jit,
    static_argnames=("n_steps", "thin", "return_trajectory", "return_diagnostics"),
)
def _flow_sample_impl(
    sampler: FlowSampler,
    x0: Array,
    key: Array,
    n_steps: int,
    thin: int,
    return_trajectory: bool,
    return_diagnostics: bool,
    model_kwargs: Dict[str, Any],
):
    sde = sampler.mode == "sde"
    t0, t1 = sampler._check_interval()
    t_phys = jnp.linspace(t0, t1, n_steps + 1, dtype=x0.dtype)

    if sde:
        sde_drift, diffusion_fn = sampler._sde_dynamics(model_kwargs)
        drift = sde_drift
        grid = t_phys
    else:
        base_drift = sampler._get_drift(model_kwargs)
        if sampler.reverse:
            drift = lambda x_, s_: -base_drift(x_, t0 + s_)
            grid = t_phys - t0
        else:
            drift = base_drift
            grid = t_phys

    adaptive = sampler.integrator.error_weights is not None
    if adaptive:
        x = sampler.integrator.integrate(
            {"x": x0}, grid[1] - grid[0], n_steps, drift=drift, t=grid
        )["x"]
        if not return_diagnostics:
            return x
        mean = jnp.mean(x, axis=0)[None]
        var = jnp.clip(jnp.var(x, axis=0), 1e-10, 1e10)[None]
        return x, {"mean": mean, "var": var, "t": t_phys[-1:]}

    # ---- fixed-step scan with thinning -------------------------------------
    n_kept = n_steps // thin
    remainder = n_steps - n_kept * thin

    def one_step(i, xc):
        dt = grid[i + 1] - grid[i]
        ti = grid[i]
        if sde:
            return sampler.integrator.step(
                {"x": xc},
                dt,
                drift=drift,
                diffusion=diffusion_fn(xc, ti),
                t=ti,
                key=jax.random.fold_in(key, i),
            )["x"]
        if sampler.integrator.family == "sde":
            # SDE integrators are valid for ODE mode with zero diffusion
            # (reference flow.py:224-229): deterministic path, noise zeroed.
            return sampler.integrator.step(
                {"x": xc}, dt, drift=drift, t=ti, noise=jnp.zeros_like(xc)
            )["x"]
        return sampler.integrator.step({"x": xc}, dt, drift=drift, t=ti)["x"]

    def outer(xc, k):
        start = k * thin
        xc = jax.lax.fori_loop(0, thin, lambda j, c: one_step(start + j, c), xc)
        outs = {}
        if return_trajectory:
            outs["traj"] = xc
        if return_diagnostics:
            outs["mean"] = jnp.mean(xc, axis=0)
            outs["var"] = jnp.clip(jnp.var(xc, axis=0), 1e-10, 1e10)
            outs["t"] = t_phys[(k + 1) * thin]
        return xc, outs

    if n_kept > 0:
        x, outs = jax.lax.scan(outer, x0, jnp.arange(n_kept))
    else:
        x, outs = x0, {}
    if remainder > 0:
        x = jax.lax.fori_loop(n_kept * thin, n_steps, one_step, x)

    if sde and sampler.last_step is not None:
        x = sampler._apply_last_step(x, t_phys[-1], drift, model_kwargs)
        # keep the recorded end state equal to the returned sample
        if n_kept > 0 and remainder == 0:
            if return_trajectory:
                outs["traj"] = outs["traj"].at[-1].set(x)
            if return_diagnostics:
                outs["mean"] = outs["mean"].at[-1].set(jnp.mean(x, axis=0))
                outs["var"] = outs["var"].at[-1].set(
                    jnp.clip(jnp.var(x, axis=0), 1e-10, 1e10)
                )
                outs["t"] = outs["t"].at[-1].set(t_phys[-1] + sampler.last_step_size)

    if return_trajectory and n_kept > 0:
        output = jnp.moveaxis(outs.pop("traj"), 0, 1)
    else:
        outs.pop("traj", None)
        output = x
    if return_diagnostics:
        return output, outs
    return output


@partial(jax.jit, static_argnames=("n_steps", "hutchinson", "n_probes"))
def _flow_logprob_impl(
    sampler: FlowSampler,
    x: Array,
    key: Array,
    n_steps: int,
    hutchinson: bool,
    n_probes: int,
    model_kwargs: Dict[str, Any],
) -> Array:
    t0, t1 = sampler._check_interval()
    drift = sampler._get_drift(model_kwargs)
    batch = x.shape[0]
    event_shape = x.shape[1:]
    d = math.prod(event_shape)

    if hutchinson:
        # Rademacher probes, fixed along the whole trajectory (standard CNF
        # practice: a smooth divergence estimate along the path).
        probes = (
            jax.random.bernoulli(key, 0.5, (n_probes, *x.shape)).astype(x.dtype) * 2.0
            - 1.0
        )

        def div_fn(xx, t):
            total = jnp.zeros((batch,), xx.dtype)
            for i in range(n_probes):
                v = probes[i]
                _, jv = jax.jvp(lambda z: drift(z, t), (xx,), (v,))
                total = total + jnp.sum((v * jv).reshape(batch, -1), axis=-1)
            return total / n_probes

    else:

        def div_fn(xx, t):
            def per_sample(xi_flat):
                f = lambda z: drift(z.reshape((1, *event_shape)), t)[0].reshape(-1)
                return jnp.trace(jax.jacfwd(f)(xi_flat))

            return jax.vmap(per_sample)(xx.reshape(batch, d))

    # backward RK4 on the augmented state (x, ∫ div u dt): physical time
    # t = t1 - s, dx/ds = -u(x, t), da/ds = ∇·u(x, t).
    span = t1 - t0
    h = span / n_steps

    def aug(xx, s):
        t = t1 - s
        return -drift(xx, t), div_fn(xx, t)

    def rk4_step(carry, i):
        xx, a = carry
        s = i * h
        k1x, k1a = aug(xx, s)
        k2x, k2a = aug(xx + 0.5 * h * k1x, s + 0.5 * h)
        k3x, k3a = aug(xx + 0.5 * h * k2x, s + 0.5 * h)
        k4x, k4a = aug(xx + h * k3x, s + h)
        xx = xx + h / 6.0 * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
        a = a + h / 6.0 * (k1a + 2.0 * k2a + 2.0 * k3a + k4a)
        return (xx, a), None

    (z, div_int), _ = jax.lax.scan(
        rk4_step, (x, jnp.zeros((batch,), x.dtype)), jnp.arange(n_steps)
    )
    return sampler.prior_logp(z) - div_int
