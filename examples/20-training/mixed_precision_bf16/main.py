"""Mixed-precision (bf16) training with the precision Policy.

Tensor cores compute matmuls in bfloat16; because bf16 keeps f32's
exponent range there is no GradScaler or loss-scaling story (the reference's
AMP machinery, ``base_module.py:143-176``, dissolves). The whole policy is a
dtype discipline — f32 master weights, bf16 compute — carried by
``torchebm_tpu.utils.bf16_policy()`` plus the models' ``dtype=`` argument.

This example trains the same flow-matching field twice (f32 and bf16 compute)
from identical seeds and shows the loss curves agree to bf16 resolution, then
runs a few bf16 PCD steps on a conv energy (the image-EBM workload where the
bf16 speedup matters).
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import time

import jax
import jax.numpy as jnp
import optax

from torchebm_tpu.core import WrappedEnergy
from torchebm_tpu.datasets import make_8gaussians
from torchebm_tpu.interpolants import LinearInterpolant
from torchebm_tpu.losses import ContrastiveDivergence
from torchebm_tpu.models import ConvEnergy2D, MLPVelocityField
from torchebm_tpu.samplers import LangevinDynamics
from torchebm_tpu.utils import bf16_policy, f32_policy


def fit_flow(policy, key, steps, batch=256):
    """Flow-matching fit at the policy's compute dtype; returns loss curve + s/step."""
    net = MLPVelocityField(hidden_dims=(256, 256), dtype=policy.compute_dtype)
    params = net.init(key, jnp.zeros((1, 2)), jnp.zeros((1,)))
    # master weights stay f32 regardless of compute dtype
    assert all(p.dtype == jnp.float32 for p in jax.tree_util.tree_leaves(params))
    interp = LinearInterpolant()
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def loss_fn(p, x1, k):
        k0, kt = jax.random.split(k)
        x0 = jax.random.normal(k0, x1.shape)
        t = jax.random.uniform(kt, (x1.shape[0],))
        xt, ut = interp.interpolate(x0, x1, t)
        return jnp.mean(jnp.square(net.apply(p, xt, t) - ut))

    @jax.jit
    def step(p, s, x1, k):
        l, g = jax.value_and_grad(loss_fn)(p, x1, k)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, l

    losses = []
    t0 = None
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        x1 = make_8gaussians(k, batch)
        params, opt_state, loss = step(params, opt_state, x1, jax.random.fold_in(k, 1))
        losses.append(loss)
        if i == 0:  # exclude compile time
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
    jax.block_until_ready(losses[-1])
    per_step = (time.perf_counter() - t0) / max(steps - 1, 1)
    return [float(l) for l in losses], per_step


def main():
    key = jax.random.PRNGKey(0)
    steps = _common.n(400, 8)

    l32, t32 = fit_flow(f32_policy(), key, steps)
    l16, t16 = fit_flow(bf16_policy(), key, steps)
    print(f"f32  final loss {sum(l32[-5:]) / 5:.4f}   {t32 * 1e3:.2f} ms/step")
    print(f"bf16 final loss {sum(l16[-5:]) / 5:.4f}   {t16 * 1e3:.2f} ms/step "
          f"(speedup {t32 / t16:.2f}x)")
    gap = abs(sum(l32[-5:]) - sum(l16[-5:])) / 5
    print(f"loss-curve gap: {gap:.4f} (bf16 resolution ~1e-2 of scale)")
    if not smoke:
        assert gap < 0.1, "bf16 training diverged from f32"

    # --- bf16 PCD on a conv energy: the matmul-heavy image-EBM configuration ---
    policy = bf16_policy()
    net = ConvEnergy2D(channels=(16, 32), dtype=policy.compute_dtype)
    shape = (1, 16, 16)
    params = net.init(key, jnp.zeros((1, *shape)))
    energy = WrappedEnergy(fn=net.apply, params=params)
    cd = ContrastiveDivergence(
        model=energy,
        sampler=LangevinDynamics(energy, step_size=5.0, clamp=(-1.0, 1.0)),
        k_steps=_common.n(20, 3),
        persistent=True,
        buffer_size=512,
        init_steps=0,
    )
    buf = cd.init_buffer(key, shape)
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)

    @jax.jit
    def pcd_step(p, s, b, x, k):
        (l, (_, b2)), g = jax.value_and_grad(lambda pp: cd(pp, x, k, b), has_aux=True)(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, b2, l

    data = jnp.clip(jax.random.normal(key, (64, *shape)) * 0.3, -1, 1)
    for i in range(_common.n(30, 3)):
        params, opt_state, buf, loss = pcd_step(
            params, opt_state, buf, data, jax.random.fold_in(key, 1000 + i)
        )
    print(f"bf16 PCD conv-energy loss after warm start: {float(loss):.4f}")
    assert jnp.isfinite(loss), "bf16 PCD produced a non-finite loss"


if __name__ == "__main__":
    main()
