r"""Patchify/unpatchify helpers and the patch embedding.

Reference: ``torchebm/models/components/patch.py:9-56``. The reference embeds
patches with a strided ``Conv2d``; a stride-P P×P convolution is exactly
patchify-then-matmul (one GEMM over ``(B·N, C·P·P) @ (C·P·P, D)``), so
:class:`ConvPatchEmbed2d` implements it that way directly. The image interface stays NCHW
for reference parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..module import Dense, Module

Array = jax.Array

__all__ = ["patchify2d", "unpatchify2d", "ConvPatchEmbed2d"]


def patchify2d(x: Array, patch_size: int) -> Array:
    """``(B, C, H, W) -> (B, N, C·P·P)`` patch tokens (reference ``patch.py:9-20``)."""
    b, c, h, w = x.shape
    p = int(patch_size)
    if h % p != 0 or w % p != 0:
        raise ValueError(f"H,W must be divisible by patch_size={p}, got {(h, w)}")
    gh, gw = h // p, w // p
    x = x.reshape(b, c, gh, p, gw, p)
    x = jnp.transpose(x, (0, 2, 4, 3, 5, 1))  # (B, gh, gw, p, p, C)
    return x.reshape(b, gh * gw, p * p * c)


def unpatchify2d(tokens: Array, patch_size: int, *, out_channels: int) -> Array:
    """``(B, N, P·P·C) -> (B, C, H, W)`` (reference ``patch.py:23-38``)."""
    b, n, d = tokens.shape
    p = int(patch_size)
    c = int(out_channels)
    if d != p * p * c:
        raise ValueError(f"Token dim {d} != patch_size^2*out_channels ({p * p * c})")
    grid = int(round(n**0.5))
    if grid * grid != n:
        raise ValueError("Number of tokens must be a perfect square for 2D unpatchify.")
    x = tokens.reshape(b, grid, grid, p, p, c)
    x = jnp.transpose(x, (0, 5, 1, 3, 2, 4))  # (B, C, gh, p, gw, p)
    return x.reshape(b, c, grid * p, grid * p)


class ConvPatchEmbed2d(Module):
    """Patch embedding: patchify + Dense (≡ strided conv, one GEMM)."""

    embed_dim: int
    patch_size: int
    dtype: jnp.dtype = jnp.float32

    def forward(self, x: Array) -> Array:
        tokens = patchify2d(x, self.patch_size)
        return Dense(self.embed_dim, dtype=self.dtype, name="proj")(tokens)
