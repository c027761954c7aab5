"""The ``core.struct`` dataclass pytrees every component is built on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.core import struct


@struct.dataclass
class Point:
    x: jax.Array
    scale: float = struct.field(pytree_node=False, default=1.0)


@struct.dataclass
class Counted:
    x: jax.Array
    calls: list = struct.field(pytree_node=False, default_factory=list)

    def __post_init__(self):
        self.calls.append(type(self.x).__name__)


def test_fields_split_into_leaves_and_static():
    p = Point(jnp.ones(3), scale=2.0)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1 and leaves[0].shape == (3,)
    assert jax.tree_util.tree_unflatten(treedef, leaves).scale == 2.0
    # a different static value is a different treedef (a new jit cache entry)
    assert treedef != jax.tree_util.tree_structure(Point(jnp.ones(3), scale=3.0))


def test_frozen_and_replace():
    p = Point(jnp.zeros(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.ones(2)
    q = p.replace(scale=5.0)
    assert q.scale == 5.0 and p.scale == 1.0 and q.x is p.x


def test_post_init_reruns_on_unflatten():
    """The contract components rely on: __post_init__ runs again whenever a
    pytree is rebuilt (inside jit it sees tracers)."""
    c = Counted(jnp.ones(2))
    assert c.calls == ["ArrayImpl"]
    jax.jit(lambda c: c.x * 2)(c)
    assert len(c.calls) >= 2 and any("Tracer" in n for n in c.calls[1:])


def test_transforms_see_through():
    p = Point(jnp.arange(3.0), scale=2.0)
    g = jax.grad(lambda p: jnp.sum(p.x**2) * p.scale)(p)
    assert isinstance(g, Point) and g.scale == 2.0
    np.testing.assert_allclose(np.asarray(g.x), [0.0, 4.0, 8.0])
    batched = jax.vmap(lambda p: p.x.sum())(Point(jnp.ones((4, 3))))
    assert batched.shape == (4,)


def test_decorating_twice_is_a_noop_and_subclasses_inherit():
    assert struct.dataclass(Point) is Point

    @struct.dataclass
    class Scaled(Point):
        shift: jax.Array = None

    s = Scaled(jnp.ones(2), shift=jnp.zeros(2))
    leaves = jax.tree_util.tree_leaves(s)
    assert len(leaves) == 2 and s.scale == 1.0
