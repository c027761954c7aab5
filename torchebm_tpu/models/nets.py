r"""Ready-made networks: MLP energy/field and a conv energy for image EBMs.

The reference ships only the DiT backbone and defines tiny MLP energies inline
in tests/examples (e.g. ``tests/distributed/test_fsdp2_score_matching.py:42-50``);
these are promoted to reusable modules here. ``ConvEnergy2D`` is a **build
addition** for PCD conv-energy training on MNIST-like images.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from .module import Conv, Dense, Module

Array = jax.Array

__all__ = ["MLPEnergy", "MLPVelocityField", "ConvEnergy2D"]


class MLPEnergy(Module):
    """Scalar energy MLP: ``(B, d) -> (B,)``. SiLU activations."""

    hidden_dims: Sequence[int] = (128, 128)
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array) -> Array:
        h = x.reshape(x.shape[0], -1).astype(self.dtype)
        for width in self.hidden_dims:
            h = jax.nn.silu(Dense(width, dtype=self.dtype)(h))
        return Dense(1, dtype=self.dtype)(h).squeeze(-1).astype(jnp.float32)


class MLPVelocityField(Module):
    """Time-conditioned vector field ``(x, t) -> dx`` for flow/EqM training.

    Time enters through a sinusoidal embedding concatenated to the input.
    """

    hidden_dims: Sequence[int] = (128, 128, 128)
    time_embed_dim: int = 32
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array, t: Array) -> Array:
        from .components.embeddings import MLPTimestepEmbedder

        d = x.shape[-1]
        te = MLPTimestepEmbedder.sinusoidal_embedding(t, self.time_embed_dim)
        h = jnp.concatenate([x, te.astype(x.dtype)], axis=-1).astype(self.dtype)
        for width in self.hidden_dims:
            h = jax.nn.silu(Dense(width, dtype=self.dtype)(h))
        return Dense(d, dtype=self.dtype)(h).astype(jnp.float32)


class ConvEnergy2D(Module):
    """Convolutional scalar energy for image EBMs: ``(B, C, H, W) -> (B,)``.

    NCHW interface (library convention); internally NHWC, the layout the
    convolution runs in. Strided SiLU convs + dense head — the standard PCD image-EBM
    architecture (swish convnet, e.g. Du & Mordatch 2019).

    ``data_format="NHWC"`` accepts channels-last input directly — for
    MCMC-in-the-loss training (PCD) the chain state, buffer and data can then
    live in the conv-native layout end to end, skipping the per-evaluation
    transpose pair (~82 per PCD step at k=40; the transpose of the input IS
    re-laid-out by XLA, it is not free).
    """

    channels: Sequence[int] = (32, 64, 64)
    dense_dim: int = 128
    dtype: jnp.dtype = jnp.float32
    data_format: str = "NCHW"

    def forward(self, x: Array) -> Array:
        if self.data_format == "NHWC":
            h = x.astype(self.dtype)
        else:
            h = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)  # NCHW -> NHWC
        for ch in self.channels:
            h = Conv(ch, (3, 3), strides=(2, 2), padding="SAME", dtype=self.dtype)(h)
            h = jax.nn.silu(h)
        h = h.reshape(h.shape[0], -1)
        h = jax.nn.silu(Dense(self.dense_dim, dtype=self.dtype)(h))
        return Dense(1, dtype=self.dtype)(h).squeeze(-1).astype(jnp.float32)
