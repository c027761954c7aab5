r"""Loss-agnostic conditional 2D transformer (DiT) backbone.

Reference: ``torchebm/models/conditional_transformer_2d.py:16-123``. Inputs are
``(B, C, H, W)`` images plus a single conditioning vector ``(B, cond_dim)``;
the conditioning may arrive positionally, as ``cond=`` or as ``t=`` (the
library-wide ``model(x, t)`` convention). Unknown keyword arguments raise
rather than being swallowed.

Design: patch embedding is patchify+GEMM, all matmuls run in the module's
compute ``dtype`` (set ``dtype=jnp.bfloat16`` for bf16 tensor-core training;
params stay float32), attention softmax is f32, and the fixed sin-cos positional
table is a trace constant (no buffer plumbing).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .components import (
    AdaLNZeroBlock,
    AdaLNZeroPatchHead,
    ConvPatchEmbed2d,
    build_2d_sincos_pos_embed,
)
from .module import Module

Array = jax.Array

__all__ = ["ConditionalTransformer2D"]


class ConditionalTransformer2D(Module):
    in_channels: int = 1
    out_channels: int = 1
    input_size: int = 32
    patch_size: int = 4
    embed_dim: int = 256
    depth: int = 6
    num_heads: int = 4
    cond_dim: Optional[int] = None
    mlp_ratio: float = 4.0
    use_sincos_pos_embed: bool = True
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array, cond: Optional[Array] = None, *, t: Optional[Array] = None) -> Array:
        c = cond if cond is not None else t
        if c is None:
            raise ValueError(
                "ConditionalTransformer2D requires a conditioning tensor via "
                "`cond` (positional) or the `cond=`/`t=` keyword."
            )
        if c.ndim == 1:
            # scalar-per-sample conditioning (e.g. raw time): lift to a vector
            c = c[:, None] * jnp.ones((1, self.cond_dim or self.embed_dim), x.dtype)

        if self.input_size % self.patch_size != 0:
            raise ValueError("input_size must be divisible by patch_size")
        grid = self.input_size // self.patch_size

        tokens = ConvPatchEmbed2d(
            embed_dim=self.embed_dim, patch_size=self.patch_size, dtype=self.dtype
        )(x)
        if self.use_sincos_pos_embed:
            pe = build_2d_sincos_pos_embed(self.embed_dim, grid)
            tokens = tokens + pe[None].astype(tokens.dtype)

        for i in range(self.depth):
            tokens = AdaLNZeroBlock(
                embed_dim=self.embed_dim,
                num_heads=self.num_heads,
                cond_dim=self.cond_dim,
                mlp_ratio=self.mlp_ratio,
                dtype=self.dtype,
                name=f"block_{i}",
            )(tokens, c)

        out = AdaLNZeroPatchHead(
            embed_dim=self.embed_dim,
            patch_size=self.patch_size,
            out_channels=self.out_channels,
            cond_dim=self.cond_dim,
            dtype=self.dtype,
            name="head",
        )(tokens, c)
        return out.astype(jnp.promote_types(x.dtype, jnp.float32))
