r"""Mixed-precision policy: params in f32, compute in bf16.

JAX replacement for the reference's AMP machinery
(``torchebm/core/base_module.py:143-176``: ``setup_mixed_precision`` +
``autocast_context`` + the trainer's GradScaler path,
``base_trainer.py:150-197``). In JAX the story is simpler:

- **bf16 has f32's exponent range**, so there is no GradScaler / loss-scaling
  — overflow handling dissolves entirely (documented in
  ``core/trainer.py:10-12``).
- The **tensor cores compute in bf16**; the policy is purely a dtype
  discipline: keep parameters and optimizer state in f32 (master weights),
  run matmuls/convs in bf16, accumulate reductions and the final loss in f32.
- In the library's networks that discipline is the module's ``dtype`` argument (params stay
  f32, activations cast per layer). Every network in
  :mod:`torchebm_tpu.models` takes ``dtype=``; :class:`Policy` packages the
  same rule for arbitrary apply functions and input batches.

Usage::

    policy = bf16_policy()
    net = MLPEnergy(dtype=policy.compute_dtype)        # module-native route
    apply = policy.wrap(net.apply)                     # or wrap any callable
    x16 = policy.cast_to_compute(batch)                # cast inputs once

``Policy.wrap`` casts floating-point array arguments to ``compute_dtype``
and floating-point outputs back to ``output_dtype`` — the functional
analogue of the reference's ``autocast_context()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

Array = jax.Array

__all__ = ["Policy", "bf16_policy", "f32_policy", "cast_floating"]


def cast_floating(tree: Any, dtype) -> Any:
    """Cast every floating-point array leaf to ``dtype`` (ints/bools pass
    through — the reference's "never dtype-cast conditioning labels" rule,
    ``base_module.py:105-141``)."""
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

    return jax.tree_util.tree_map(cast, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """A jmp-style three-dtype precision policy.

    - ``param_dtype``: master parameter / optimizer-state dtype (keep f32).
    - ``compute_dtype``: matmul/activation dtype (bf16 for tensor cores).
    - ``output_dtype``: dtype of user-facing outputs (losses, energies).
    """

    param_dtype: Any = jnp.float32
    compute_dtype: Any = jnp.float32
    output_dtype: Any = jnp.float32

    def cast_to_param(self, tree: Any) -> Any:
        return cast_floating(tree, self.param_dtype)

    def cast_to_compute(self, tree: Any) -> Any:
        return cast_floating(tree, self.compute_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return cast_floating(tree, self.output_dtype)

    def wrap(self, fn: Callable) -> Callable:
        """Autocast wrapper: float array args → ``compute_dtype``, float
        outputs → ``output_dtype``. Non-array / integer args pass through."""

        def wrapped(*args, **kwargs):
            args = self.cast_to_compute(args)
            kwargs = self.cast_to_compute(kwargs)
            return self.cast_to_output(fn(*args, **kwargs))

        return wrapped


def bf16_policy() -> Policy:
    """The standard mixed-precision policy: f32 params, bf16 compute, f32 outputs."""
    return Policy(jnp.float32, jnp.bfloat16, jnp.float32)


def f32_policy() -> Policy:
    """Full-precision policy (the default everywhere when no policy is used)."""
    return Policy(jnp.float32, jnp.float32, jnp.float32)
