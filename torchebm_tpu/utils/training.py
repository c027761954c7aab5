r"""Training utilities: EMA, parameter freezing, checkpointing.

Reference: ``torchebm/utils/training.py:11-118``. JAX translation:

- ``update_ema`` is a pure pytree blend (the reference's in-place
  ``mul_/add_`` loop over a param dict).
- ``requires_grad`` (a torch flag-setter) has no pytree analogue; its role —
  excluding parameters from optimization — is served by
  :func:`freeze_mask` + ``optax.masked``.
- Checkpoints are Orbax (``save_checkpoint``/``load_checkpoint``): params,
  EMA, optimizer state, step, and any extra state (replay buffers, PRNG keys)
  as one pytree — the JAX-canonical persistence layer.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "update_ema",
    "freeze_mask",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint_step",
]


def update_ema(ema_params: Any, params: Any, decay: float = 0.9999) -> Any:
    r"""Exponential moving average blend: ``ema = decay·ema + (1-decay)·params``.

    Pure and jittable; matches reference semantics (``training.py:11-32``).
    """
    return jax.tree_util.tree_map(
        lambda e, p: decay * e + (1.0 - decay) * p, ema_params, params
    )


def freeze_mask(params: Any, predicate: Callable[[tuple, Any], bool]) -> Any:
    """Boolean mask pytree for ``optax.masked``: True = trainable.

    ``predicate(path, leaf)`` receives the key path (tuple of names). The JAX
    analogue of the reference's ``requires_grad(model, flag)``
    (``training.py:35-41``).
    """
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    treedef = jax.tree_util.tree_structure(params)
    mask_leaves = [
        bool(predicate(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path), leaf))
        for path, leaf in flat
    ]
    return jax.tree_util.tree_unflatten(treedef, mask_leaves)


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params: Any,
    *,
    ema_params: Any = None,
    opt_state: Any = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a step-numbered Orbax checkpoint; returns its path.

    Mirrors the reference's step-numbered util checkpoints with EMA + optimizer
    (``training.py:42-84``); ``extra`` carries replay buffers / scheduler steps
    / PRNG keys.
    """
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step):08d}")
    payload = {"step": int(step), "params": params}
    if ema_params is not None:
        payload["ema_params"] = ema_params
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if extra:
        payload["extra"] = extra
    _checkpointer().save(path, payload, force=True)
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name))
    ]
    return max(steps) if steps else None


def _restore_args(template: Any):
    """Per-leaf Orbax restore args carrying the template's SHARDINGS.

    Every ``jax.Array`` leaf restores directly onto its template sharding
    (fsdp/batch ``NamedSharding`` on a mesh, or single-device) — the
    preemption-safe mesh-resume path. Without this Orbax restores host-side
    and warns "Sharding info not provided… unsafe when restoring on a
    different topology"; with it, restore is sharding-aware end to end.
    """
    import orbax.checkpoint as ocp

    def leaf(x):
        if isinstance(x, jax.Array):
            return ocp.ArrayRestoreArgs(
                sharding=x.sharding, global_shape=x.shape, dtype=x.dtype
            )
        return ocp.RestoreArgs()

    return jax.tree_util.tree_map(leaf, template)


def load_checkpoint(
    ckpt_dir: str, step: Optional[int] = None, *, template: Any = None
) -> Dict[str, Any]:
    """Load a checkpoint dict (latest step when ``step`` is None).

    ``template`` (a payload-shaped pytree) restores exact array types/dtypes
    AND placements: every array leaf is restored onto the template leaf's
    sharding (see :func:`_restore_args`), so an fsdp-sharded
    :class:`~torchebm_tpu.core.trainer.TrainState` resumes directly onto its
    mesh with no host-side detour.
    """
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints found under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step):08d}")
    if template is not None:
        return _checkpointer().restore(
            path, item=template, restore_args=_restore_args(template)
        )
    # Template-less convenience load: no topology expectation exists, so
    # restore array leaves host-side (numpy) from the checkpoint's own
    # metadata and re-device them — avoids Orbax's "sharding info not
    # provided … unsafe on a different topology" file-sharding path.
    import numpy as np
    import orbax.checkpoint as ocp

    meta = _checkpointer().metadata(path).item_metadata.tree

    def leaf(m):
        if isinstance(m, ocp.metadata.ScalarMetadata):
            return ocp.RestoreArgs()
        if isinstance(m, ocp.metadata.ArrayMetadata):
            return ocp.ArrayRestoreArgs(restore_type=np.ndarray)
        return ocp.RestoreArgs()

    payload = _checkpointer().restore(path, restore_args=jax.tree_util.tree_map(leaf, meta))
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, payload
    )
