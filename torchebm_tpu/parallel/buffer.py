r"""Sharded replay-buffer operations for multi-device/multi-host PCD.

Build addition with no reference analogue (SURVEY §7 "hard parts"):
persistent-CD replay buffers sharded over the ``data`` axis need periodic
cross-device shuffling so each device's chains mix over the global buffer.
Design: keep the buffer dim-0 sharded; a global permutation applied under
``jit`` lets XLA emit the all-to-all between devices. ``shuffle_every`` steps of a
training loop, call :func:`shuffle_sharded`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..losses.contrastive_divergence import ReplayBuffer

Array = jax.Array

__all__ = ["shuffle_sharded", "shard_replay_buffer"]


def shard_replay_buffer(buffer: ReplayBuffer, mesh: Mesh, axis: str = "data") -> ReplayBuffer:
    """Place the buffer samples dim-0-sharded over ``axis`` (pointer replicated)."""
    spec = P(axis, *([None] * (buffer.samples.ndim - 1)))
    return ReplayBuffer(
        samples=jax.device_put(buffer.samples, NamedSharding(mesh, spec)),
        ptr=jax.device_put(buffer.ptr, NamedSharding(mesh, P())),
    )


def shuffle_sharded(key: Array, buffer: ReplayBuffer) -> ReplayBuffer:
    """Globally permute a (possibly sharded) replay buffer.

    One compiled gather; on a sharded buffer XLA lowers it to the cross-device
    all-to-all exchange. The write pointer is preserved (the ring semantics are
    invariant under permutation of contents).
    """
    perm = jax.random.permutation(key, buffer.samples.shape[0])
    shuffled = jnp.take(buffer.samples, perm, axis=0)
    # Preserve the input placement. Eagerly (concrete arrays) re-place with
    # device_put; under jit, tracers carry no concrete sharding — there the
    # consumer's sharding propagation/out_shardings governs placement.
    try:
        sharding = buffer.samples.sharding
        shuffled = jax.device_put(shuffled, sharding)
    except Exception:
        pass
    return ReplayBuffer(samples=shuffled, ptr=buffer.ptr)
