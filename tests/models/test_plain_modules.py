"""The plain-JAX networks against the same computations built from
``flax.linen`` layers.

The library's modules (``models/module.py``) keep flax's parameter paths,
initialisers and key derivation, so one parameter tree drives both: each
case initialises the flax twin, checks the plain module's own ``init``
gives the same tree bit for bit, perturbs the tree (adaLN-Zero layers start
at zero) and compares the outputs per compute dtype.
"""

from typing import Optional, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.models import (
    AdaLNZeroBlock,
    AdaLNZeroPatchHead,
    ConditionalTransformer2D,
    ConvEnergy2D,
    ConvPatchEmbed2d,
    FeedForward,
    LabelEmbedder,
    MLPEnergy,
    MLPTimestepEmbedder,
    MLPVelocityField,
    MultiheadSelfAttention,
    build_2d_sincos_pos_embed,
    modulate,
    patchify2d,
    unpatchify2d,
)

# ----------------------------------------------------------- flax twins


def _ln(eps, dtype):
    return nn.LayerNorm(use_bias=False, use_scale=False, epsilon=eps, dtype=dtype)


class FMLPEnergy(nn.Module):
    hidden_dims: Sequence[int] = (32, 32)
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        h = x.reshape(x.shape[0], -1).astype(self.dtype)
        for w in self.hidden_dims:
            h = nn.silu(nn.Dense(w, dtype=self.dtype)(h))
        return nn.Dense(1, dtype=self.dtype)(h).squeeze(-1).astype(jnp.float32)


class FMLPVelocityField(nn.Module):
    hidden_dims: Sequence[int] = (32, 32)
    time_embed_dim: int = 16
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, t):
        te = MLPTimestepEmbedder.sinusoidal_embedding(t, self.time_embed_dim)
        h = jnp.concatenate([x, te.astype(x.dtype)], axis=-1).astype(self.dtype)
        for w in self.hidden_dims:
            h = nn.silu(nn.Dense(w, dtype=self.dtype)(h))
        return nn.Dense(x.shape[-1], dtype=self.dtype)(h).astype(jnp.float32)


class FConvEnergy2D(nn.Module):
    channels: Sequence[int] = (8, 16)
    dense_dim: int = 32
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        h = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)
        for ch in self.channels:
            h = nn.silu(nn.Conv(ch, (3, 3), strides=(2, 2), padding="SAME", dtype=self.dtype)(h))
        h = h.reshape(h.shape[0], -1)
        h = nn.silu(nn.Dense(self.dense_dim, dtype=self.dtype)(h))
        return nn.Dense(1, dtype=self.dtype)(h).squeeze(-1).astype(jnp.float32)


class FTimestep(nn.Module):
    out_dim: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, t):
        f = MLPTimestepEmbedder.sinusoidal_embedding(t, 256)
        h = nn.silu(nn.Dense(self.out_dim, dtype=self.dtype)(f))
        return nn.Dense(self.out_dim, dtype=self.dtype)(h)


class FLabel(nn.Module):
    num_classes: int
    out_dim: int

    @nn.compact
    def __call__(self, labels, force_drop_mask=None):
        table = nn.Embed(self.num_classes + 1, self.out_dim)
        if force_drop_mask is not None:
            labels = jnp.where(force_drop_mask, self.num_classes, labels)
        return table(labels)


class FAttention(nn.Module):
    embed_dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, n, d = x.shape
        hd = self.embed_dim // self.num_heads
        qkv = nn.Dense(3 * self.embed_dim, dtype=self.dtype, name="qkv")(x)
        qkv = qkv.reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = jnp.einsum("bnhd,bmhd->bhnm", q, k) * hd**-0.5
        w = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(x.dtype)
        y = jnp.einsum("bhnm,bmhd->bnhd", w, v).reshape(b, n, d)
        return nn.Dense(self.embed_dim, dtype=self.dtype, name="out_proj")(y)


class FFeedForward(nn.Module):
    embed_dim: int
    mlp_ratio: float = 4.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(int(self.embed_dim * self.mlp_ratio), dtype=self.dtype)(x)
        return nn.Dense(self.embed_dim, dtype=self.dtype)(nn.gelu(h, approximate=True))


class FBlock(nn.Module):
    embed_dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, c):
        mod = nn.Dense(6 * self.embed_dim, dtype=self.dtype, name="modulation",
                       kernel_init=nn.initializers.zeros)(nn.silu(c))
        s1, sc1, g1, s2, sc2, g2 = jnp.split(mod, 6, axis=1)
        attn = FAttention(self.embed_dim, self.num_heads, dtype=self.dtype,
                          name="MultiheadSelfAttention_0")
        mlp = FFeedForward(self.embed_dim, dtype=self.dtype, name="FeedForward_0")
        x = x + g1[:, None] * attn(modulate(_ln(1e-6, self.dtype)(x), s1, sc1))
        return x + g2[:, None] * mlp(modulate(_ln(1e-6, self.dtype)(x), s2, sc2))


class FHead(nn.Module):
    embed_dim: int
    patch_size: int
    out_channels: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, tokens, c):
        mod = nn.Dense(2 * self.embed_dim, dtype=self.dtype, name="modulation",
                       kernel_init=nn.initializers.zeros)(nn.silu(c))
        shift, scale = jnp.split(mod, 2, axis=1)
        tokens = modulate(_ln(1e-6, self.dtype)(tokens), shift, scale)
        p = nn.Dense(self.patch_size**2 * self.out_channels, dtype=self.dtype, name="proj",
                     kernel_init=nn.initializers.zeros)(tokens)
        return unpatchify2d(p, self.patch_size, out_channels=self.out_channels)


class FPatch(nn.Module):
    embed_dim: int
    patch_size: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.embed_dim, dtype=self.dtype, name="proj")(patchify2d(x, self.patch_size))


class FDiT(nn.Module):
    embed_dim: int = 32
    depth: int = 2
    num_heads: int = 4
    patch_size: int = 4
    input_size: int = 16
    cond_dim: Optional[int] = 16
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, c):
        grid = self.input_size // self.patch_size
        tok = FPatch(self.embed_dim, self.patch_size, self.dtype, name="ConvPatchEmbed2d_0")(x)
        tok = tok + build_2d_sincos_pos_embed(self.embed_dim, grid)[None].astype(tok.dtype)
        for i in range(self.depth):
            tok = FBlock(self.embed_dim, self.num_heads, self.dtype, name=f"block_{i}")(tok, c)
        out = FHead(self.embed_dim, self.patch_size, 1, self.dtype, name="head")(tok, c)
        return out.astype(jnp.promote_types(x.dtype, jnp.float32))


# ---------------------------------------------------------------- cases

KEY = jax.random.PRNGKey(0)
X2 = jax.random.normal(KEY, (5, 3))
T = jnp.linspace(0.1, 0.9, 5)
IMG = jax.random.normal(KEY, (3, 1, 16, 16))
TOK = jax.random.normal(KEY, (3, 16, 32))
COND = jax.random.normal(jax.random.fold_in(KEY, 1), (3, 16))


def _cases(dtype):
    return {
        "MLPEnergy": (MLPEnergy(hidden_dims=(32, 32), dtype=dtype), FMLPEnergy(dtype=dtype), (X2,)),
        "MLPVelocityField": (
            MLPVelocityField(hidden_dims=(32, 32), time_embed_dim=16, dtype=dtype),
            FMLPVelocityField(dtype=dtype), (X2, T)),
        "ConvEnergy2D": (ConvEnergy2D(channels=(8, 16), dense_dim=32, dtype=dtype),
                         FConvEnergy2D(dtype=dtype), (IMG,)),
        "MLPTimestepEmbedder": (MLPTimestepEmbedder(out_dim=24, dtype=dtype),
                                FTimestep(24, dtype), (T,)),
        "MultiheadSelfAttention": (MultiheadSelfAttention(32, 4, dtype=dtype),
                                   FAttention(32, 4, dtype), (TOK,)),
        "FeedForward": (FeedForward(32, dtype=dtype), FFeedForward(32, dtype=dtype), (TOK,)),
        "AdaLNZeroBlock": (AdaLNZeroBlock(32, 4, cond_dim=16, dtype=dtype),
                           FBlock(32, 4, dtype), (TOK, COND)),
        "AdaLNZeroPatchHead": (AdaLNZeroPatchHead(32, 4, 1, dtype=dtype),
                               FHead(32, 4, 1, dtype), (TOK, COND)),
        "ConvPatchEmbed2d": (ConvPatchEmbed2d(32, 4, dtype=dtype), FPatch(32, 4, dtype), (IMG,)),
        "ConditionalTransformer2D": (
            ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=16, patch_size=4,
                                     embed_dim=32, depth=2, num_heads=4, cond_dim=16, dtype=dtype),
            FDiT(dtype=dtype), (IMG, COND)),
    }


NAMES = list(_cases(jnp.float32))


def _perturb(tree, key):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [l + 0.05 * jax.random.normal(k, l.shape) for l, k in zip(leaves, keys)])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_matches_flax_layers(name, dtype):
    plain, twin, args = _cases(dtype)[name]
    ref_vars = twin.init(KEY, *args)
    vars_ = plain.init(KEY, *args)
    assert jax.tree_util.tree_structure(vars_) == jax.tree_util.tree_structure(ref_vars)
    for a, b in zip(jax.tree_util.tree_leaves(vars_), jax.tree_util.tree_leaves(ref_vars)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    params = _perturb(ref_vars, jax.random.fold_in(KEY, 9))
    got = plain.apply(params, *args)
    want = twin.apply(params, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("drop", [None, "half"])
def test_label_embedder_matches_flax_embed(drop):
    plain = LabelEmbedder(num_classes=10, out_dim=8, dropout_prob=0.1)
    twin = FLabel(10, 8)
    labels = jnp.arange(6) % 10
    mask = None if drop is None else (jnp.arange(6) % 2 == 0)
    ref_vars = twin.init(KEY, labels)
    vars_ = plain.init(KEY, labels)
    np.testing.assert_array_equal(
        np.asarray(vars_["params"]["Embed_0"]["embedding"]),
        np.asarray(ref_vars["params"]["Embed_0"]["embedding"]),
    )
    np.testing.assert_array_equal(
        np.asarray(plain.apply(vars_, labels, force_drop_mask=mask)),
        np.asarray(twin.apply(ref_vars, labels, mask)),
    )


def test_label_dropout_uses_its_stream():
    emb = LabelEmbedder(num_classes=10, out_dim=4, dropout_prob=0.5)
    labels = jnp.arange(512) % 10
    v = emb.init(KEY, labels)
    a = emb.apply(v, labels, train=True, rngs={"label_dropout": jax.random.PRNGKey(1)})
    b = emb.apply(v, labels, train=True, rngs={"label_dropout": jax.random.PRNGKey(1)})
    c = emb.apply(v, labels, train=True, rngs={"label_dropout": jax.random.PRNGKey(2)})
    null = v["params"]["Embed_0"]["embedding"][10]
    dropped = np.mean(np.all(np.asarray(a) == np.asarray(null), axis=-1))
    assert 0.4 < dropped < 0.6
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    with pytest.raises(ValueError, match="label_dropout"):
        emb.apply(v, labels, train=True)


def test_modules_are_hashable_and_jit_static():
    """Networks ride as static jit arguments (``WrappedEnergy.fn``)."""
    a = MLPEnergy(hidden_dims=[16, 16])
    b = MLPEnergy(hidden_dims=(16, 16))
    assert a == b and hash(a) == hash(b)
    v = a.init(KEY, X2)
    f = jax.jit(lambda p, x, net: net.apply(p, x), static_argnums=2)
    np.testing.assert_allclose(np.asarray(f(v, X2, a)), np.asarray(b.apply(v, X2)), rtol=1e-5)


def test_missing_parameter_and_outside_call_raise():
    net = MLPEnergy(hidden_dims=(8,))
    with pytest.raises(KeyError, match="Dense_1"):
        net.apply({"params": {"Dense_0": net.init(KEY, X2)["params"]["Dense_0"]}}, X2)
    with pytest.raises(RuntimeError, match="inside Module.init"):
        net(X2)
