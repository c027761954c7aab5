"""Immutable dataclass pytrees: the library's component base.

A small stand-in for ``flax.struct`` built on :mod:`jax.tree_util`, so the
library needs nothing beyond JAX for its components. Same surface:

- :func:`dataclass` makes a frozen dataclass, registers it as a pytree and
  adds ``.replace(**updates)``;
- :func:`field` with ``pytree_node=False`` marks static metadata (part of the
  treedef, hashed by ``jit``); every other field is a traced leaf.

Unflattening calls the class constructor, so ``__post_init__`` re-runs on
every unflatten (inside ``jit``, ``vmap``, ``scan``...). Keep it idempotent
and free of side effects on traced fields.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, TypeVar, overload

import jax

__all__ = ["dataclass", "field"]

_T = TypeVar("_T")


def field(pytree_node: bool = True, *, metadata=None, **kwargs):
    """A dataclass field; ``pytree_node=False`` keeps it out of the leaves."""
    return dataclasses.field(
        metadata=dict(metadata or {}, pytree_node=pytree_node), **kwargs
    )


@overload
def dataclass(clz: _T, **kwargs) -> _T: ...


@overload
def dataclass(**kwargs) -> Callable[[_T], _T]: ...


def dataclass(clz=None, **kwargs):
    """Turn ``clz`` into a frozen dataclass registered as a pytree."""
    if clz is None:
        return lambda c: dataclass(c, **kwargs)
    if "_struct_dataclass" in clz.__dict__:
        return clz
    kwargs.setdefault("frozen", True)
    data_clz = dataclasses.dataclass(**kwargs)(clz)
    data_fields, meta_fields = [], []
    for f in dataclasses.fields(data_clz):
        (data_fields if f.metadata.get("pytree_node", True) else meta_fields).append(
            f.name
        )

    def replace(self, **updates):
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)

    data_clz.replace = replace
    jax.tree_util.register_dataclass(data_clz, data_fields, meta_fields)
    data_clz._struct_dataclass = True
    return data_clz
