r"""Sampler contract and the shared compiled sampling loop.

JAX re-design of ``torchebm/core/base_sampler.py:10-155``. The reference's
``sample()`` runs a host-Python loop launching device kernels per step; here
the **entire chain** — thinning, trajectory recording, diagnostics, scheduler
advancement — compiles to a single XLA program via nested
``lax.scan``/``fori_loop``, for any energy.

Contract parity (reference ``base_sampler.py``):

- ``sample(key, x=None, dim=None, n_steps=100, n_samples=1, thin=1,
  return_trajectory=False, return_diagnostics=False, model_kwargs=None)``
- returns samples ``(n_samples, *data_shape)``, or trajectory
  ``(n_samples, n_steps//thin, *data_shape)`` when ``return_trajectory``;
  optionally paired with a diagnostics dict of arrays of length
  ``n_steps//thin`` (keys ``mean``/``var``/``energy`` + sampler-specific,
  e.g. ``acceptance_rate``).
- the explicit ``generator`` threading contract (``base_sampler.py:140-144``)
  becomes mandatory ``jax.random`` key threading; per-rank decorrelation is
  ``jax.random.fold_in(key, rank)``.

Subclasses implement three small hooks (``init_carry`` / ``step`` /
``extra_diagnostics``) and inherit the compiled loop.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy

Array = jax.Array

__all__ = ["BaseSampler"]

#: env override for the sampler RNG implementation ("auto", "threefry", "rbg",
#: "unsafe_rbg").
_RNG_IMPL_ENV = "TORCHEBM_RNG_IMPL"


def _upgrade_key(key: Array, impl: str = "auto") -> Array:
    """Rewrap a threefry key for the sampler's PRNG implementation.

    ``impl`` is ``"threefry"``, ``"rbg"`` or ``"unsafe_rbg"``; ``"auto"``
    keeps threefry. ``rbg``/``unsafe_rbg`` keep threefry-strength
    ``split``/``fold_in`` but draw bits through XLA's ``RngBitGenerator``.
    Explicitly typed non-threefry keys are respected as-is; raw ``uint32``
    key arrays (legacy ``jax.random.PRNGKey``) and typed threefry keys are
    rewrapped by duplicating their 2-word data into rbg's 4-word layout.
    ``TORCHEBM_RNG_IMPL`` overrides ``impl``.
    """
    impl = os.environ.get(_RNG_IMPL_ENV, impl)
    if impl in ("auto", "threefry"):
        return key
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        if "threefry" not in str(jax.random.key_impl(key)):
            return key  # caller explicitly chose an impl; respect it
        data = jax.random.key_data(key)
    else:
        data = jnp.asarray(key)
    if data.shape[-1] == 2:  # threefry 2-word data -> rbg 4-word data
        data = jnp.concatenate([data, data], axis=-1)
    return jax.random.wrap_key_data(data, impl=impl)


def _concrete_scalar(p) -> bool:
    """True for a Python number or a concrete (non-traced) 0-d array — the
    forms the chain kernels can bake into a trace (e.g. the device scalar
    step size returned by dual-averaging warmup)."""
    if isinstance(p, (int, float)):
        return True
    return (
        isinstance(p, jax.Array)
        and not isinstance(p, jax.core.Tracer)
        and jnp.ndim(p) == 0
    )


@partial(
    jax.jit,
    static_argnames=(
        "n_steps",
        "thin",
        "return_trajectory",
        "return_diagnostics",
    ),
)
def _sample_impl(
    sampler: "BaseSampler",
    x0: Array,
    key: Array,
    n_steps: int,
    thin: int,
    return_trajectory: bool,
    return_diagnostics: bool,
    model_kwargs: Dict[str, Any],
):
    """The shared compiled sampling loop.

    Structure: an outer ``scan`` over the ``n_steps // thin`` kept slots, each
    running ``thin`` transition steps in an inner ``fori_loop``, followed by
    the ``n_steps % thin`` remainder steps (the reference records at
    ``(i+1) % thin == 0``, so trailing steps still execute,
    ``langevin_dynamics.py:163-185``). Step index ``i`` drives schedulers and
    per-step key folding.
    """
    n_kept = n_steps // thin
    remainder = n_steps - n_kept * thin
    unroll = max(1, int(getattr(sampler, "unroll", 1)))

    carry0 = sampler.init_carry(x0, jax.random.fold_in(key, n_steps), model_kwargs)

    # The chain preserves the caller's state dtype: a bf16 x0 stays bf16 even
    # when f32 model parameters or scheduler scalars promote intermediate
    # math (without this the scan carry would change dtype and fail to
    # trace). Mixed-precision contract pinned in tests/test_bf16_battery.py.
    carry_dtypes = jax.tree_util.tree_map(lambda a: jnp.asarray(a).dtype, carry0)

    def one_step(i, carry):
        new = sampler.step(carry, i, jax.random.fold_in(key, i), model_kwargs)
        return jax.tree_util.tree_map(
            lambda a, d: jnp.asarray(a).astype(d), new, carry_dtypes
        )

    def outer(carry, k):
        start = k * thin

        def inner(j, c):
            return one_step(start + j, c)

        carry = jax.lax.fori_loop(0, thin, inner, carry, unroll=min(unroll, thin))
        x = carry["x"]
        outs = {}
        if return_trajectory:
            outs["traj"] = x
        if return_diagnostics:
            mean = jnp.mean(x, axis=0)
            var = jnp.clip(jnp.var(x, axis=0), 1e-10, 1e10)
            outs["mean"] = mean
            outs["var"] = var
            outs["energy"] = jnp.mean(sampler.energy_of(x, model_kwargs))
            outs.update(sampler.extra_diagnostics(carry, model_kwargs))
        return carry, outs

    # unroll semantics: amortize per-transition loop overhead. With thin == 1
    # the outer scan does the stepping (unroll it); with thin > 1 each outer
    # iteration already runs `thin` inner steps (unroll those instead).
    outer_unroll = min(unroll, n_kept) if thin == 1 else 1
    if n_kept > 0:
        carry, outs = jax.lax.scan(
            outer, carry0, jnp.arange(n_kept), unroll=outer_unroll
        )
    else:
        carry, outs = carry0, {}
    if remainder > 0:
        carry = jax.lax.fori_loop(
            n_kept * thin, n_steps, one_step, carry, unroll=min(unroll, remainder)
        )

    x_final = carry["x"]
    if return_trajectory and n_kept > 0:
        # scan stacked kept states as (n_kept, B, *ds) -> (B, n_kept, *ds)
        traj = jnp.moveaxis(outs.pop("traj"), 0, 1)
        output = traj
    elif return_trajectory:
        output = x_final[:, None]
        outs = dict(outs)
        outs.pop("traj", None)
    else:
        outs = dict(outs)
        outs.pop("traj", None)
        output = x_final

    if return_diagnostics:
        return output, outs
    return output


class BaseSampler:
    """Sampler base. Concrete samplers are ``core.struct`` pytrees subclassing this.

    Required fields on subclasses: ``model`` (an :class:`Energy`). Hooks:

    - ``init_carry(x0, key, model_kwargs) -> dict`` with at least ``"x"``.
    - ``step(carry, i, key, model_kwargs) -> carry`` — one transition at step
      index ``i`` (schedulers evaluate at ``i``; matches the reference's
      step-then-advance convention).
    - ``extra_diagnostics(carry, model_kwargs) -> dict`` — per-kept-slot extras
      (e.g. ``acceptance_rate``).

    Optional static knobs (plain class attributes or non-pytree dataclass
    fields on subclasses):

    - ``rng_impl`` (default ``"auto"``): PRNG implementation for the chain
      (see :func:`_upgrade_key`).
    - ``unroll`` (default 1): unroll factor for the compiled transition loop.
      Amortizes per-step loop overhead for cheap (analytic-energy) steps;
      leave at 1 for expensive (neural) energies where compile time would
      grow for no throughput gain.
    """

    # NOTE: deliberately un-annotated — an annotation here would be inherited
    # into subclasses' dataclass fields as a traced pytree leaf.
    rng_impl = "auto"

    # ------------------------------------------------------------------ hooks
    def init_carry(self, x0: Array, key: Array, model_kwargs) -> Dict[str, Any]:
        return {"x": x0}

    def step(self, carry, i, key, model_kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def extra_diagnostics(self, carry, model_kwargs) -> Dict[str, Array]:
        return {}

    def _step_kwargs(self, model_kwargs, step):
        """Thread the step index to step-aware energies (``wants_step`` models,
        e.g. InteractionModel with a scheduled strength — the stateless analogue
        of the reference advancing Schedulables inside the sampler subtree)."""
        mk = dict(model_kwargs or {})
        if step is not None and getattr(self.model, "wants_step", False):
            mk["step"] = step
        return mk

    def energy_of(self, x: Array, model_kwargs, step=None) -> Array:
        return self.model.energy(x, **self._step_kwargs(model_kwargs, step))

    def gradient_of(self, x: Array, model_kwargs, step=None) -> Array:
        return self.model.gradient(x, **self._step_kwargs(model_kwargs, step))

    # ------------------------------------------------------------------ API
    def _init_state(
        self,
        key: Array,
        x: Optional[Array],
        dim: Optional[Union[int, Tuple[int, ...]]],
        n_samples: int,
    ) -> Array:
        """Coerce ``x`` or draw ``N(0, I)`` (reference ``base_sampler.py:46-74``)."""
        if x is not None:
            return jnp.asarray(x)
        if dim is None:
            raise ValueError("Either `x` or `dim` must be provided.")
        shape = (dim,) if isinstance(dim, int) else tuple(dim)
        return jax.random.normal(key, (n_samples, *shape), jnp.float32)

    def sample(
        self,
        key: Array,
        x: Optional[Array] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_steps: int = 100,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Run the compiled chain. See module docstring for the shape contract."""
        if thin < 1:
            raise ValueError("thin must be >= 1")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        key = _upgrade_key(key, getattr(self, "rng_impl", "auto"))
        key_init, key_run = jax.random.split(key)
        x0 = self._init_state(key_init, x, dim, n_samples)
        return _sample_impl(
            self,
            x0,
            key_run,
            n_steps,
            thin,
            bool(return_trajectory),
            bool(return_diagnostics),
            model_kwargs or {},
        )
