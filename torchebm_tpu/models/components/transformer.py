r"""Transformer building blocks with adaLN-Zero conditioning.

Reference: ``torchebm/models/components/transformer.py:10-109``. QKV is one
fused Dense (a single GEMM); attention softmax runs in float32
regardless of the compute ``dtype`` (bf16-safe); the adaLN modulation head is
zero-initialized so every block starts as the identity.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..module import Dense, Module, layer_norm, zeros

Array = jax.Array

__all__ = ["modulate", "MultiheadSelfAttention", "FeedForward", "AdaLNZeroBlock"]


def modulate(x: Array, shift: Array, scale: Array) -> Array:
    """adaLN modulation: ``x·(1+scale) + shift`` with per-sample (B, D) params."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class MultiheadSelfAttention(Module):
    """Self-attention with fused QKV projection and f32 softmax accumulation."""

    embed_dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array) -> Array:
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim ({self.embed_dim}) must be divisible by num_heads ({self.num_heads})"
            )
        b, n, d = x.shape
        head_dim = self.embed_dim // self.num_heads
        qkv = Dense(3 * self.embed_dim, dtype=self.dtype, name="qkv")(x)
        qkv = qkv.reshape(b, n, 3, self.num_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, hd)

        scale = head_dim**-0.5
        logits = jnp.einsum("bnhd,bmhd->bhnm", q, k) * scale
        weights = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(x.dtype)
        y = jnp.einsum("bhnm,bmhd->bnhd", weights, v).reshape(b, n, d)
        return Dense(self.embed_dim, dtype=self.dtype, name="out_proj")(y)


class FeedForward(Module):
    embed_dim: int
    mlp_ratio: float = 4.0
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array) -> Array:
        hidden = int(self.embed_dim * self.mlp_ratio)
        h = Dense(hidden, dtype=self.dtype)(x)
        h = jax.nn.gelu(h, approximate=True)
        return Dense(self.embed_dim, dtype=self.dtype)(h)


class AdaLNZeroBlock(Module):
    """Transformer block with adaLN-Zero conditioning (zero-init modulation)."""

    embed_dim: int
    num_heads: int
    cond_dim: Optional[int] = None
    mlp_ratio: float = 4.0
    eps: float = 1e-6
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array, cond: Array) -> Array:
        mod = Dense(
            6 * self.embed_dim,
            kernel_init=zeros,
            bias_init=zeros,
            dtype=self.dtype,
            name="modulation",
        )(jax.nn.silu(cond))
        shift1, scale1, gate1, shift2, scale2, gate2 = jnp.split(mod, 6, axis=1)

        norm = lambda h: layer_norm(h, self.eps, self.dtype)
        attn = MultiheadSelfAttention(self.embed_dim, self.num_heads, dtype=self.dtype)
        mlp = FeedForward(self.embed_dim, self.mlp_ratio, dtype=self.dtype)

        x = x + gate1[:, None, :] * attn(modulate(norm(x), shift1, scale1))
        x = x + gate2[:, None, :] * mlp(modulate(norm(x), shift2, scale2))
        return x
