r"""Output head: adaLN-Zero modulated projection to patch pixels.

Reference: ``torchebm/models/components/heads.py:12-46`` (zero-init projection
so the backbone starts by predicting zeros).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..module import Dense, Module, layer_norm, zeros

from .patch import unpatchify2d
from .transformer import modulate

Array = jax.Array

__all__ = ["AdaLNZeroPatchHead"]


class AdaLNZeroPatchHead(Module):
    embed_dim: int
    patch_size: int
    out_channels: int
    cond_dim: Optional[int] = None
    eps: float = 1e-6
    dtype: jnp.dtype = jnp.float32

    def forward(self, tokens: Array, cond: Array) -> Array:
        mod = Dense(
            2 * self.embed_dim,
            kernel_init=zeros,
            bias_init=zeros,
            dtype=self.dtype,
            name="modulation",
        )(jax.nn.silu(cond))
        shift, scale = jnp.split(mod, 2, axis=1)
        tokens = modulate(
            layer_norm(tokens, self.eps, self.dtype),
            shift,
            scale,
        )
        patches = Dense(
            self.patch_size * self.patch_size * self.out_channels,
            kernel_init=zeros,
            bias_init=zeros,
            dtype=self.dtype,
            name="proj",
        )(tokens)
        return unpatchify2d(patches, self.patch_size, out_channels=self.out_channels)
