r"""A minimal module system for the library's networks, in plain JAX.

Networks are frozen dataclasses whose ``forward`` builds the computation by
calling sub-modules, as in ``flax.linen``'s compact style, and the surface is
the one users of that style expect:

- ``variables = net.init(key, *args, **kwargs)`` returns ``{"params": tree}``;
  ``key`` may also be a dict ``{"params": k, <rng name>: k, ...}``;
- ``net.apply(variables, *args, rngs={name: key}, **kwargs)`` runs it.

Parameter trees follow the same paths: a sub-module is named by its ``name=``
or, if it has none, ``<ClassName>_<i>`` counted per class within its parent;
:class:`Dense` and :class:`Conv` hold ``kernel``/``bias``, :class:`Embed`
holds ``embedding``. Kernels are ``(in, out)`` (``(kh, kw, in, out)`` for
convolutions), lecun-normal initialised, biases zero.

Mixed precision follows the same rule: parameters are stored in float32 and,
with ``dtype=jnp.bfloat16``, inputs and parameters are cast to ``dtype``
before each matrix product.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array

__all__ = ["Module", "Dense", "Conv", "Embed", "layer_norm", "lecun_normal", "zeros"]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
_embed_init = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)

_STATE = threading.local()


class _Scope:
    """The parameters and random streams of one module instance."""

    def __init__(self, params: Dict[str, Any], rngs, path: Tuple[str, ...], init: bool):
        self.params = params
        self.rngs = rngs
        self.path = path
        self.initializing = init
        self._names: Dict[str, int] = {}
        self._draws: Dict[str, int] = {}

    def child(self, name: str) -> "_Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        return _Scope(sub, self.rngs, self.path + (name,), self.initializing)

    def auto_name(self, cls_name: str) -> str:
        i = self._names.get(cls_name, 0)
        self._names[cls_name] = i + 1
        return f"{cls_name}_{i}"

    def make_rng(self, name: str):
        """Key number ``n`` of stream ``name`` here: the stream's key folded
        with a hash of (module path, n), so keys do not depend on call order
        across modules."""
        if name not in self.rngs:
            raise ValueError(f"this call needs rngs={{{name!r}: key}}")
        n = self._draws[name] = self._draws.get(name, 0) + 1
        digest = hashlib.sha1()
        for part in self.path:
            digest.update(part.encode())
        digest.update(n.to_bytes((n.bit_length() + 7) // 8, "big"))
        salt = int.from_bytes(digest.digest()[:4], "big")
        return jax.random.fold_in(self.rngs[name], jnp.uint32(salt))

    def param(self, name: str, init: Callable, shape, dtype=jnp.float32) -> Array:
        if name in self.params:
            return self.params[name]
        if not self.initializing:
            raise KeyError(f"missing parameter {'/'.join(self.path + (name,))}")
        value = init(self.make_rng("params"), shape, dtype)
        self.params[name] = value
        return value


def _current() -> _Scope:
    stack = getattr(_STATE, "stack", None)
    if not stack:
        raise RuntimeError(
            "modules run inside Module.init/Module.apply or a parent's forward"
        )
    return stack[-1]


def _run(scope: _Scope, fn: Callable, *args, **kwargs):
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(scope)
    try:
        return fn(*args, **kwargs)
    finally:
        stack.pop()


@dataclasses.dataclass(frozen=True)
class Module:
    """Base of the library's networks. Subclasses become frozen dataclasses
    and implement ``forward``; inside it ``self.param`` and ``self.make_rng``
    reach this instance's parameters and random streams. ``name`` (keyword
    only) fixes the instance's key in its parent's parameter tree."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                object.__setattr__(self, f.name, tuple(v))

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        parent = _current()
        name = self.name or parent.auto_name(type(self).__name__)
        return _run(parent.child(name), self.forward, *args, **kwargs)

    # -- entry points --------------------------------------------------------
    def init(self, key, *args, **kwargs) -> Dict[str, Any]:
        """Create the parameters by tracing one call on example inputs."""
        rngs = dict(key) if isinstance(key, dict) else {"params": key}
        params: Dict[str, Any] = {}
        _run(_Scope(params, rngs, (), True), self.forward, *args, **kwargs)
        return {"params": params}

    def apply(self, variables, *args, rngs=None, **kwargs):
        """Run ``forward`` with the given ``{"params": ...}`` variables."""
        params = variables["params"] if "params" in variables else variables
        return _run(_Scope(params, dict(rngs or {}), (), False), self.forward, *args, **kwargs)

    # -- helpers for forward -------------------------------------------------
    def param(self, name: str, init: Callable, shape, dtype=jnp.float32) -> Array:
        return _current().param(name, init, shape, dtype)

    def make_rng(self, name: str):
        return _current().make_rng(name)


def _cast(dtype, *xs):
    dtype = dtype if dtype is not None else jnp.result_type(*xs)
    return [jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int = 1
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = lecun_normal
    bias_init: Callable = zeros

    def forward(self, x: Array) -> Array:
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features))
        bias = self.param("bias", self.bias_init, (self.features,)) if self.use_bias else None
        if bias is not None:
            x, kernel, bias = _cast(self.dtype, x, kernel, bias)
        else:
            x, kernel = _cast(self.dtype, x, kernel)
        y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class Conv(Module):
    """2-D convolution on channels-last ``(B, H, W, C)`` input."""

    features: int = 1
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
    dtype: Any = None

    def forward(self, x: Array) -> Array:
        kernel = self.param(
            "kernel", lecun_normal, (*self.kernel_size, x.shape[-1], self.features)
        )
        bias = self.param("bias", zeros, (self.features,))
        x, kernel, bias = _cast(self.dtype, x, kernel, bias)
        y = jax.lax.conv_general_dilated(
            x,
            kernel,
            window_strides=self.strides,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y + bias


class Embed(Module):
    """Row lookup in a ``(num_embeddings, features)`` table."""

    num_embeddings: int = 1
    features: int = 1

    def forward(self, ids: Array) -> Array:
        table = self.param("embedding", _embed_init, (self.num_embeddings, self.features))
        return jnp.take(table, ids, axis=0)


def layer_norm(x: Array, eps: float = 1e-6, dtype=None) -> Array:
    """Parameter-free layer norm over the last axis, statistics in float32."""
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, axis=-1, keepdims=True) - mean * mean, 0.0)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return y.astype(dtype if dtype is not None else x.dtype)
