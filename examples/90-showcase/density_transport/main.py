"""Density transport: assemble an image out of noise with annealed Langevin.

Mirrors the reference's density-transport showcase
(``examples/90-showcase/01-density-transport``): interpret a grayscale image
as an unnormalized Boltzmann density p(x) ∝ img(x), build the energy
E(x) = -log img(x) by bilinear interpolation (an Energy like any other —
autodiff gradients included), and anneal 50k Langevin particles from pure
noise onto the picture. Everything — interpolation, gradient, annealing
schedule, the whole chain — compiles to one XLA program.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp
from torchebm_tpu.core import struct

from torchebm_tpu.core import CosineScheduler, Energy, LinearScheduler
from torchebm_tpu.samplers import LangevinDynamics


def make_image(size=64):
    """Procedural target: a glyph — a ring plus three bars."""
    y, x = jnp.mgrid[0:size, 0:size] / (size - 1) * 2 - 1
    r = jnp.sqrt(x**2 + y**2)
    ring = jnp.exp(-(((r - 0.7) / 0.08) ** 2))
    bars = sum(
        jnp.exp(-((x - cx) / 0.07) ** 2) * (jnp.abs(y) < 0.45)
        for cx in (-0.3, 0.0, 0.3)
    )
    img = jnp.clip(ring + bars, 0.0, 1.0)
    return img / jnp.max(img)


@struct.dataclass
class ImageEnergy(Energy):
    """E(x) = -log(img(x) + eps) with bilinear interpolation over [-1,1]^2."""

    img: jax.Array
    eps: float = struct.field(pytree_node=False, default=1e-3)

    def energy(self, x):
        size = self.img.shape[0]
        # map [-1, 1]^2 -> pixel coords (row = -y so the image is upright)
        col = (x[..., 0] + 1.0) * 0.5 * (size - 1)
        row = (1.0 - (x[..., 1] + 1.0) * 0.5) * (size - 1)
        r0 = jnp.clip(jnp.floor(row), 0, size - 2)
        c0 = jnp.clip(jnp.floor(col), 0, size - 2)
        fr, fc = row - r0, col - c0
        r0, c0 = r0.astype(jnp.int32), c0.astype(jnp.int32)
        v = (self.img[r0, c0] * (1 - fr) * (1 - fc)
             + self.img[r0 + 1, c0] * fr * (1 - fc)
             + self.img[r0, c0 + 1] * (1 - fr) * fc
             + self.img[r0 + 1, c0 + 1] * fr * fc)
        # quadratic well outside the frame keeps particles in range
        wall = jnp.sum(jnp.maximum(jnp.abs(x) - 1.0, 0.0) ** 2, axis=-1)
        return -jnp.log(v + self.eps) + 50.0 * wall


def ascii_render(x, size=32):
    h, _, _ = jnp.histogram2d(x[:, 1], x[:, 0], bins=size,
                              range=[[-1, 1], [-1, 1]])
    shades = " .:-=+*#%@"
    h = jnp.sqrt(h / (jnp.max(h) + 1e-9))
    return "\n".join(
        "".join(shades[int(v * (len(shades) - 1))] for v in row)
        for row in jnp.flipud(h)
    )


def main():
    key = jax.random.PRNGKey(0)
    img = make_image(64)
    e = ImageEnergy(img=img)

    n = 5_000 if smoke else 50_000
    n_steps = _common.n(3000, 100)

    # Annealed Langevin: start hot (noise_scale 1 explores), end cold
    # (small steps settle onto the bright set). Both schedules advance inside
    # the compiled scan.
    sampler = LangevinDynamics(
        e,
        step_size=CosineScheduler(2e-3, 5e-5, n_steps),
        noise_scale=LinearScheduler(1.0, 0.05, n_steps),
        clamp=(-1.2, 1.2),
    )
    x = sampler.sample(key, x=jax.random.normal(key, (n, 2)) * 0.5,
                       n_steps=n_steps)

    print(f"{n} particles annealed over {n_steps} steps onto the density:")
    print(ascii_render(x))
    # quality metric: mean brightness at the particle positions
    bright = float(jnp.mean(jnp.exp(-e(x))))
    base = float(jnp.mean(img))
    print(f"mean target brightness at particles {bright:.3f} "
          f"vs image mean {base:.3f} (higher = sharper assembly)")
    print("OK")


if __name__ == "__main__":
    main()
