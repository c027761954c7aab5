"""Input-pipeline utilities: batch stacking and host→device prefetch.

The reference leans on ``torch.utils.data.DataLoader`` for overlap
(``torchebm/datasets/generators.py`` Datasets feed a DataLoader); the
JAX equivalents are explicit:

- :func:`stack_batches` turns an iterable of per-step batches into the
  stacked pytree :meth:`~torchebm_tpu.core.trainer.BaseTrainer.train_epoch_scanned`
  consumes (leading steps axis on every leaf).
- :func:`prefetch_to_device` overlaps host batch preparation with device
  compute by keeping ``size`` batches in flight via ``jax.device_put``
  (device transfers are async; the device queue does the overlapping).
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp

__all__ = ["stack_batches", "prefetch_to_device"]


def stack_batches(batches: Iterable[Any]) -> Any:
    """Stack an iterable of identically-structured batches along a new
    leading steps axis.

    Accepts the trainer's batch forms — bare arrays, ``(data, cond_dict)``
    tuples, or ``{"data": ..., **cond}`` dicts — and returns the same
    structure with every leaf stacked: the input to
    ``BaseTrainer.train_epoch_scanned``. Raises on an empty iterable or
    mismatched structures/shapes.
    """
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    treedef = jax.tree_util.tree_structure(batches[0])
    for b in batches[1:]:
        if jax.tree_util.tree_structure(b) != treedef:
            raise ValueError(
                "All batches must share one pytree structure; got "
                f"{jax.tree_util.tree_structure(b)} vs {treedef}"
            )
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *batches)


def prefetch_to_device(
    batches: Iterable[Any],
    size: int = 2,
    device: Optional[jax.Device] = None,
    sharding: Optional[Any] = None,
) -> Iterator[Any]:
    """Yield batches with ``size`` transfers in flight ahead of the consumer.

    ``jax.device_put`` is asynchronous, so enqueueing the next batch(es)
    before the consumer needs them overlaps host preparation + PCIe/ICI
    transfer with device compute — the JAX analogue of a DataLoader's
    prefetch. Pass ``sharding`` (e.g. ``batch_sharding(mesh, ndim)``) to
    prefetch directly into a sharded layout for multi-device steps;
    otherwise ``device`` (default: the default device) receives the batch.
    """
    if size < 1:
        raise ValueError("size must be >= 1")
    put_target = sharding if sharding is not None else device

    def put(b):
        if put_target is None:
            return jax.tree_util.tree_map(jnp.asarray, b)
        return jax.tree_util.tree_map(lambda a: jax.device_put(a, put_target), b)

    it = iter(batches)
    queue: collections.deque = collections.deque()
    for b in itertools.islice(it, size):
        queue.append(put(b))
    while queue:
        nxt = next(it, _SENTINEL)
        if nxt is not _SENTINEL:
            queue.append(put(nxt))
        yield queue.popleft()


_SENTINEL = object()
