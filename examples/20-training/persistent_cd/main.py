"""Persistent contrastive divergence: the replay buffer as functional state.

Mirrors the reference's persistent-CD lesson
(``examples/20-training/01-mcmc-losses/02-persistent-cd``): with
``persistent=True`` negatives start from a replay buffer instead of the data,
so chains effectively run for thousands of steps across updates while each
update only pays for k. The JAX twist: the buffer is an explicit pytree
threaded through a single jitted train step — update, MCMC, FIFO push, and
the gradient all compile into one XLA program.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp
import optax

from torchebm_tpu.core import WrappedEnergy
from torchebm_tpu.datasets import make_8gaussians
from torchebm_tpu.losses import PersistentContrastiveDivergence
from torchebm_tpu.models import MLPEnergy
from torchebm_tpu.samplers import LangevinDynamics


def main():
    key = jax.random.PRNGKey(0)
    net = MLPEnergy(hidden_dims=(128, 128))
    params = net.init(key, jnp.zeros((1, 2)))
    energy = WrappedEnergy(fn=net.apply, params=params)

    cd = PersistentContrastiveDivergence(
        model=energy,
        sampler=LangevinDynamics(energy, step_size=0.01, clamp=(-6.0, 6.0)),
        k_steps=_common.n(20, 5),       # short chains per update ...
        buffer_size=4096,               # ... long effective chains via buffer
        init_steps=0,
        new_sample_ratio=0.05,          # 5% of starts get exploration noise
    )
    buffer = cd.init_buffer(key, (2,))

    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, buffer, x, k):
        (loss, (neg, buffer)), grads = jax.value_and_grad(cd, has_aux=True)(
            params, x, k, buffer
        )
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, buffer, loss, neg

    steps = _common.n(1500, 20)
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        x = make_8gaussians(k, 256, std=0.2, scale=2.0)
        params, opt_state, buffer, loss, neg = train_step(
            params, opt_state, buffer, x, jax.random.fold_in(k, 1)
        )
        if i % max(steps // 6, 1) == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {float(loss):+.4f}  "
                  f"buffer mean radius {float(jnp.mean(jnp.linalg.norm(buffer.samples, axis=-1))):.2f}")

    # The buffer IS the model's sample estimate: after training it should sit
    # on the 8 modes (radius 2), not at its 0.01-noise init.
    e = energy.replace(params=params)
    data = make_8gaussians(jax.random.fold_in(key, 9), 512, std=0.2, scale=2.0)
    on = float(jnp.mean(e(data)))
    off = float(jnp.mean(e(jnp.full((512, 2), 4.0))))
    print(f"E[data]={on:.3f}  E[off-manifold]={off:.3f}  (data should be lower)")
    r = float(jnp.mean(jnp.linalg.norm(buffer.samples, axis=-1)))
    print(f"replay-buffer mean radius {r:.2f} (target ~2.0)")
    print("OK")


if __name__ == "__main__":
    main()
