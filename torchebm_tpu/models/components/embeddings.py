r"""Timestep and label embedders (reference ``components/embeddings.py:10-92``)."""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from ..module import Dense, Embed, Module

Array = jax.Array

__all__ = ["MLPTimestepEmbedder", "LabelEmbedder"]


class MLPTimestepEmbedder(Module):
    """Sinusoidal frequency embedding of a scalar timestep followed by an MLP."""

    out_dim: int
    frequency_embedding_size: int = 256
    dtype: jnp.dtype = jnp.float32

    @staticmethod
    def sinusoidal_embedding(t: Array, dim: int, max_period: int = 10_000) -> Array:
        half = dim // 2
        freqs = jnp.exp(
            -math.log(max_period) * jnp.arange(half, dtype=jnp.float32) / half
        )
        args = t[:, None].astype(jnp.float32) * freqs[None]
        emb = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
        if dim % 2:
            emb = jnp.concatenate([emb, jnp.zeros_like(emb[:, :1])], axis=-1)
        return emb

    def forward(self, t: Array) -> Array:
        t = t.reshape(t.shape[0]) if t.ndim != 1 else t
        freq = self.sinusoidal_embedding(t, self.frequency_embedding_size)
        h = Dense(self.out_dim, dtype=self.dtype)(freq)
        h = jax.nn.silu(h)
        return Dense(self.out_dim, dtype=self.dtype)(h)


class LabelEmbedder(Module):
    """Label embedding with classifier-free-guidance token dropping.

    With ``dropout_prob > 0`` an extra row encodes the null/unconditional
    label (id ``num_classes``). Training-time dropping draws from the
    ``"label_dropout"`` random stream (``apply(..., rngs=...)``); ``force_drop_mask`` overrides it.
    """

    num_classes: int
    out_dim: int
    dropout_prob: float = 0.0

    @property
    def null_label_id(self) -> Optional[int]:
        return self.num_classes if self.dropout_prob > 0 else None

    def forward(
        self,
        labels: Array,
        *,
        train: bool = False,
        force_drop_mask: Optional[Array] = None,
    ) -> Array:
        use_null = self.dropout_prob > 0
        table = Embed(self.num_classes + (1 if use_null else 0), self.out_dim)
        if use_null and (train or force_drop_mask is not None):
            if force_drop_mask is None:
                rng = self.make_rng("label_dropout")
                drop = jax.random.uniform(rng, (labels.shape[0],)) < self.dropout_prob
            else:
                drop = force_drop_mask.astype(bool)
            labels = jnp.where(drop, jnp.full_like(labels, self.null_label_id), labels)
        return table(labels)
