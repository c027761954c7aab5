"""Class-conditional DiT flow matching on digit images + CFG generation.

The flagship-model slice of BASELINE config 5: the
``ConditionalTransformer2D`` (DiT) backbone conditioned on timestep + label
embeddings (with label dropout), trained by conditional flow matching on
28x28 digits, then sampled class-conditionally through ``FlowSampler`` with
the ``LabelClassifierFreeGuidance`` wrapper.

Set ``dtype=jnp.bfloat16`` on the backbone for bf16 tensor-core matmuls.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp
import optax

from torchebm_tpu.datasets import load_mnist
from torchebm_tpu.interpolants import LinearInterpolant
from torchebm_tpu.models import (
    ConditionalTransformer2D,
    LabelClassifierFreeGuidance,
    LabelEmbedder,
    MLPTimestepEmbedder,
)
from torchebm_tpu.models.module import Module
from torchebm_tpu.samplers import FlowSampler

NUM_CLASSES = 10


class LabelDiT(Module):
    """DiT velocity field conditioned on (timestep, label) embeddings."""

    embed_dim: int = 128
    depth: int = 4
    num_heads: int = 4
    patch_size: int = 4
    label_dropout: float = 0.1
    dtype: jnp.dtype = jnp.float32

    def forward(self, x, t, *, y, train: bool = False):
        c = MLPTimestepEmbedder(out_dim=self.embed_dim, dtype=self.dtype)(t)
        c = c + LabelEmbedder(
            num_classes=NUM_CLASSES,
            out_dim=self.embed_dim,
            dropout_prob=self.label_dropout,
        )(y, train=train)
        return ConditionalTransformer2D(
            in_channels=1,
            out_channels=1,
            input_size=28,
            patch_size=self.patch_size,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            cond_dim=self.embed_dim,
            dtype=self.dtype,
        )(x, c)


def main():
    key = jax.random.PRNGKey(0)
    images, labels = load_mnist("train")
    if smoke:
        images, labels = images[:512], labels[:512]
    print(f"dataset: {images.shape}, labels {labels.shape}")

    # TORCHEBM_BF16=1 flips on the mixed-precision policy: params/optimizer
    # stay f32 master weights, the backbone's matmuls run in bf16
    # (torchebm_tpu.utils.bf16_policy; reference base_module.py:143-176).
    from torchebm_tpu.utils import bf16_policy, f32_policy

    policy = bf16_policy() if os.environ.get("TORCHEBM_BF16") == "1" else f32_policy()
    print(f"compute dtype: {policy.compute_dtype.__name__}")
    net = LabelDiT(
        embed_dim=64 if smoke else 192,
        depth=2 if smoke else 6,
        num_heads=2 if smoke else 6,
        dtype=policy.compute_dtype,
    )
    x_init = jnp.zeros((1, 1, 28, 28))
    params = net.init(
        {"params": key, "label_dropout": key},
        x_init, jnp.zeros((1,)), y=jnp.zeros((1,), jnp.int32), train=True,
    )
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    print(f"DiT params: {n_params/1e6:.2f}M")

    interp = LinearInterpolant()
    opt = optax.adamw(2e-4)
    opt_state = opt.init(params)

    def loss_fn(p, x1, y, k):
        k0, kt, kd = jax.random.split(k, 3)
        x0 = jax.random.normal(k0, x1.shape)
        t = jax.random.uniform(kt, (x1.shape[0],))
        xt, ut = interp.interpolate(x0, x1, t)
        pred = net.apply(p, xt, t, y=y, train=True, rngs={"label_dropout": kd})
        return jnp.mean(jnp.square(pred - ut))

    @jax.jit
    def step(p, s, x1, y, k):
        l, g = jax.value_and_grad(loss_fn)(p, x1, y, k)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, l

    steps = _common.n(1500, 5)
    batch = 128
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        idx = jax.random.randint(k, (batch,), 0, images.shape[0])
        params, opt_state, loss = step(
            params, opt_state, images[idx], labels[idx], jax.random.fold_in(k, 1)
        )
        if i % max(steps // 5, 1) == 0 or i == steps - 1:
            print(f"step {i:5d}  flow-matching loss {float(loss):.4f}")

    # class-conditional CFG sampling: guided field = uncond + s*(cond - uncond)
    def field(x, t, *, y):
        return net.apply(params, x, t, y=y, train=False)

    cfg = LabelClassifierFreeGuidance(
        base=field, null_label_id=NUM_CLASSES, cfg_scale=1.0 if smoke else 2.5,
        guide_channels=1,
    )
    sampler = FlowSampler(model=cfg, integrator="euler")
    n_per_class = 2 if smoke else 16
    y_gen = jnp.repeat(jnp.arange(NUM_CLASSES, dtype=jnp.int32), n_per_class)
    gen = sampler.sample(
        jax.random.fold_in(key, 7),
        dim=(1, 28, 28),
        n_samples=NUM_CLASSES * n_per_class,
        n_steps=_common.n(100, 8),
        model_kwargs={"y": y_gen},
    )
    print(f"generated {gen.shape}, pixel range [{float(gen.min()):.2f}, {float(gen.max()):.2f}]")

    # check class identity: generated class means should correlate best with
    # the matching data class mean
    data_means = jnp.stack(
        [jnp.mean(images[labels == c], axis=0).ravel() for c in range(NUM_CLASSES)]
    )
    gen_means = jnp.stack(
        [jnp.mean(gen[y_gen == c], axis=0).ravel() for c in range(NUM_CLASSES)]
    )
    norm = lambda m: (m - m.mean(1, keepdims=True)) / (m.std(1, keepdims=True) + 1e-8)
    corr = norm(gen_means) @ norm(data_means).T / data_means.shape[1]
    match = float(jnp.mean(jnp.argmax(corr, axis=1) == jnp.arange(NUM_CLASSES)))
    print(f"class-mean correlation match rate: {match:.2f}")
    if not smoke:
        assert match >= 0.5, "conditional generation ignored the labels"
    print("OK")


if __name__ == "__main__":
    main()
