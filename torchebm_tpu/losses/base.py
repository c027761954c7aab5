r"""Loss contracts and parameter-injection plumbing.

JAX re-design of ``torchebm/core/base_loss.py``. The torch design holds
a mutable ``nn.Module`` whose parameters autograd tracks implicitly; here the
trainable parameters are passed **explicitly** to every loss call and injected
into the stored :class:`~torchebm_tpu.core.energies.WrappedEnergy` (and into
the sampler that shares it), so ``jax.value_and_grad(loss)(params, ...)`` is
the differentiation contract. The entire FSDP2/DTensor functional-path
machinery of the reference (``base_loss.py:439-622``) dissolves: pjit-sharded
parameters differentiate transparently, and composed ``jax.grad`` replaces
``create_graph=True`` double backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy, WrappedEnergy, as_energy

Array = jax.Array

__all__ = ["BaseLoss", "inject_params"]


def inject_params(model: Any, params: Any) -> Any:
    """Return ``model`` with ``params`` swapped in (if it carries any).

    ``WrappedEnergy``/``WrappedField``-style wrappers get ``replace(params=...)``;
    analytic energies (no ``params`` field) pass through unchanged — in that
    case ``params`` must be ``None``.
    """
    if params is None:
        return model
    if hasattr(model, "params") and hasattr(model, "replace"):
        return model.replace(params=params)
    raise TypeError(
        f"Cannot inject params into {type(model).__name__}; wrap your apply "
        "function in WrappedEnergy/WrappedField (or pass params=None for "
        "parameter-free analytic energies)."
    )


class BaseLoss:
    """Loss base contract.

    Concrete losses are ``flax.struct`` pytrees with a ``model`` field.
    Call convention::

        loss = loss_fn(params, x, key, model_kwargs=...)        # stateless
        loss, aux = cd(params, x, key, state, model_kwargs=...) # stateful (CD)

    ``params=None`` uses the stored model's own parameters (analytic energies
    or frozen wrappers).
    """

    def _model(self, params: Any = None):
        return inject_params(self.model, params)

    def __call__(self, params, x, key, *args, **kwargs):
        raise NotImplementedError
