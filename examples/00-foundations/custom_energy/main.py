"""Custom energies: one method unlocks the whole library.

Mirrors the reference's custom-energy lesson
(``examples/00-foundations/01-energy/02-custom-energy``): implement
``energy(x) -> (B,)`` and autodiff gradients, scores, Langevin sampling, and
losses all derive from it. Here the energy is a pytree dataclass, so its
parameters are jit/vmap/grad-transparent and trainable.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp
from torchebm_tpu.core import struct

from torchebm_tpu.core import Energy, as_energy
from torchebm_tpu.samplers import LangevinDynamics


@struct.dataclass
class TiltedGaussianEnergy(Energy):
    """E(x) = 0.5 * ||x - mu||^2 / s^2 + a * sum(x) — a tilted isotropic bowl.

    ``mu``/``scale``/``tilt`` are pytree leaves: jitted samplers don't
    recompile when they change, and ``jax.grad`` can differentiate *through*
    them (e.g. to fit mu by maximum likelihood).
    """

    mu: jax.Array
    scale: jax.Array
    tilt: jax.Array

    def energy(self, x):
        quad = 0.5 * jnp.sum((x - self.mu) ** 2, axis=-1) / self.scale**2
        return quad + self.tilt * jnp.sum(x, axis=-1)


def main():
    key = jax.random.PRNGKey(0)
    e = TiltedGaussianEnergy(
        mu=jnp.array([1.0, -1.0]), scale=jnp.array(0.7), tilt=jnp.array(0.5)
    )

    x = jnp.array([[0.0, 0.0], [1.0, -1.0]])
    print("energy:", e(x))
    print("autodiff gradient:", e.gradient(x))
    print("score (= -grad):", e.score(x))

    # Closed form: the stationary density is N(mu - tilt*s^2, s^2 I).
    target_mean = e.mu - e.tilt * e.scale**2
    sampler = LangevinDynamics(e, step_size=0.05)
    samples = sampler.sample(key, dim=2, n_samples=4096, n_steps=_common.n(1000, 50))
    print(f"sample mean {jnp.mean(samples, 0)}  target {target_mean}")
    print(f"sample std  {jnp.std(samples, 0)}  target {e.scale}")

    # Bare callables work too (as_energy), including closures over params.
    bowl = as_energy(lambda x: 0.5 * jnp.sum(x * x, axis=-1))
    print("as_energy gradient at [1,1]:", bowl.gradient(jnp.ones((1, 2))))

    # Energies are differentiable *objects*: fit mu to data by grad descent
    # on the pytree itself — no module system required.
    data = jax.random.normal(jax.random.fold_in(key, 1), (512, 2)) * 0.3 + 2.0

    def nll_surrogate(en):
        # score matching-flavored: match the score at the data to zero drift
        return jnp.mean(jnp.sum(en.gradient(data) ** 2, axis=-1))

    fitted = e
    for _ in range(_common.n(200, 10)):
        g = jax.grad(nll_surrogate)(fitted)
        fitted = jax.tree.map(lambda p, gg: p - 0.1 * gg, fitted, g)
    print(f"fitted mu {fitted.mu} (data mean ~2.0 after tilt correction)")
    print("OK")


if __name__ == "__main__":
    main()
